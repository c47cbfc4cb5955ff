"""KKT systems of the loop solver: dense LDL, condensed, refinement."""
