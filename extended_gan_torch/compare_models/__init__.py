"""The model comparison harness: ``python -m
extended_gan_torch.compare_models`` (``__main__.py``)."""
