"""Batched geometric distortion on the device."""
