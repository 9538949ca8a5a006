"""Wav IO and device selection."""
