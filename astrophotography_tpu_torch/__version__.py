"""Version of the astrophotography_tpu_torch package (semver)."""

__version__ = "0.1.0"
