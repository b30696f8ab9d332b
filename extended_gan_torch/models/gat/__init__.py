"""Graph-attention models."""
