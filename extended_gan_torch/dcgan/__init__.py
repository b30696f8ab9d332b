"""DCGAN training from the command line: ``python -m extended_gan_torch.dcgan``."""
