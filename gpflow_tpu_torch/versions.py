"""The package's version (counterpart of ``gpflow_tpu/versions.py``)."""
__version__ = "0.1.0"
