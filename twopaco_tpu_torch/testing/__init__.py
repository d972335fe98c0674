"""Seeded test and benchmark inputs (numpy)."""
