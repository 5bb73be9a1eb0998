"""Configuration system: hyperpyyaml-compatible loading, CLI and the
registry that resolves the YAMLs' class paths onto the port."""

from . import registry
from .arguments import parse_arguments
from .experiment import create_experiment_directory
from .hyperyaml import HyperYamlError, Placeholder, load_hyperpyyaml

__all__ = [
    "parse_arguments",
    "create_experiment_directory",
    "load_hyperpyyaml",
    "HyperYamlError",
    "Placeholder",
    "registry",
]
