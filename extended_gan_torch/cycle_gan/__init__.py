"""CycleGAN training from the command line: ``python -m extended_gan_torch.cycle_gan``."""
