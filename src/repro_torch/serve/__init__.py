"""Batched serving runtime for the LM archs (slot-based continuous batching)."""
