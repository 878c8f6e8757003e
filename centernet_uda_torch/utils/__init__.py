"""Optimizer/schedule and weight-bridge utilities."""
