"""Experiment configuration."""

from .config import ExperimentConfig, load_experiment_config

__all__ = ["ExperimentConfig", "load_experiment_config"]
