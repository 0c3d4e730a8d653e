"""K6: the fused leverage-score quadratic form."""
