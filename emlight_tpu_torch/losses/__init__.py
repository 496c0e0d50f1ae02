"""Losses of the port: GAN objectives and the Sinkhorn anchor loss."""
