"""Batched solves over instances that share one cone layout."""
