"""Losses of the port (GAN objectives)."""
