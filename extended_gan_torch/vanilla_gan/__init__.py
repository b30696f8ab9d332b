"""The vanilla MLP GAN from the command line: ``python -m extended_gan_torch.vanilla_gan``."""
