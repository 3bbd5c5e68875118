"""Spec definitions and the spec-driven runner."""
