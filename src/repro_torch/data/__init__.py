"""Synthetic RouterBench-like corpus and the evaluation protocol."""
