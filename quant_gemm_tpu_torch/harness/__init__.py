"""Seeded data and error metrics for differential testing."""
