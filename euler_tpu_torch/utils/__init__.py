"""Layers, aggregators, encoders and metrics of the port."""


def hash64(s) -> int:
    """Stable 64-bit hash of a string or bytes, the engine's (copy of
    euler_tpu/utils/__init__.py:hash64): data prep maps string node ids
    through it (tools/generate_data.py)."""
    from euler_tpu_torch.core import lib as _libmod

    data = s.encode() if isinstance(s, str) else bytes(s)
    return int(_libmod.load().etg_hash64(data, len(data)))
