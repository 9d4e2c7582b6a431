"""Architecture configurations: a copy of ``repro.configs``."""
