"""Frozen metric arithmetic: peaks, FLOP and byte counts, kernel bounds."""
