"""Cone specifications and the static cone layout."""
