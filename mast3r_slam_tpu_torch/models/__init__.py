"""MASt3R network, its weight conversion, and the oracle predictors."""
