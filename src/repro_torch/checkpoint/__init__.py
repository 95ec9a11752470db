from .ckpt import SIDECAR_SCHEMA_VERSION, load, load_sidecar, save

__all__ = ["SIDECAR_SCHEMA_VERSION", "load", "load_sidecar", "save"]
