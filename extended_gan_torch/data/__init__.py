"""Host data: tensor files, synthetic KNMI archives, streaming loaders."""
