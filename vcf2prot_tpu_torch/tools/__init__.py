"""Command-line tools of the port beside its CLI: the twins of the
user-facing wrappers in ``automation_scripts/``."""
