"""Whole-utterance enhancement."""
