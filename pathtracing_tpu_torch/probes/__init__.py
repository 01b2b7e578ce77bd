"""Micro-benchmarks of single device operations, each with its hand-written kernel."""
