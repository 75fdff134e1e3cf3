"""Acoustic-model training: losses, optimizer, train step and the trainer."""
