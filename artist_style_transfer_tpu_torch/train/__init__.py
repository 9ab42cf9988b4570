"""Pixel optimization (Gatys); training comes in a later slice."""
