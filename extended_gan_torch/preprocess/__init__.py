"""Dataset preprocessing tools (port of ``extended_gan_tpu/preprocess``):
``kmni``, ``arai``, ``coastal_sea`` and ``train_test_split``, each run as
``python -m extended_gan_torch.preprocess.<name>``."""
