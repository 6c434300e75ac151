"""Serving: the two-stage recommender and the JSON-lines request loop."""
