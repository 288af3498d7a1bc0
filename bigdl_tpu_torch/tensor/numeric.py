"""Numeric typeclass registry (counterpart of
`bigdl_tpu/tensor/numeric.py`) over torch dtypes.

The reference's `TensorNumeric[T]` names the dtypes the way the Scala
reference does ("float", "double", ...); the model-file format
(`serialization/module_serializer.py`) writes a dtype-valued constructor
argument under that name, so the two packages read each other's names.
"""

from __future__ import annotations

import numpy as np
import torch


class TensorNumeric:
    """Named dtype registry: the reference's names, torch's dtypes."""

    _BY_NAME = {
        "float": torch.float32,
        "double": torch.float64,
        "half": torch.float16,
        "bfloat16": torch.bfloat16,
        "int": torch.int32,
        "long": torch.int64,
        "short": torch.int16,
        "char": torch.int8,
        "boolean": torch.bool,
        "string": np.dtype("O"),  # string columns stay numpy arrays
    }

    @classmethod
    def dtype(cls, name):
        """Resolve a reference-style dtype name or pass a dtype through."""
        if isinstance(name, str):
            key = name.lower()
            if key not in cls._BY_NAME:
                raise ValueError(f"unknown numeric type: {name}")
            return cls._BY_NAME[key]
        return name

    @classmethod
    def name_of(cls, dtype) -> str:
        """The reference's name of a torch or numpy dtype (numpy's own
        name for one the table lacks)."""
        if isinstance(dtype, torch.dtype):
            for name, d in cls._BY_NAME.items():
                if d is dtype:
                    return name
            return str(dtype).replace("torch.", "")
        dt = np.dtype(dtype)
        for name, d in cls._BY_NAME.items():
            nd = d if isinstance(d, np.dtype) else _NUMPY.get(d)
            if nd is not None and nd == dt:
                return name
        return str(dt)

    @classmethod
    def is_floating(cls, dtype) -> bool:
        if isinstance(dtype, torch.dtype):
            return dtype.is_floating_point
        return np.issubdtype(np.dtype(dtype), np.floating)


#: the numpy twin of each torch dtype in the table (bf16 has none)
_NUMPY = {torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64),
          torch.float16: np.dtype(np.float16),
          torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64),
          torch.int16: np.dtype(np.int16), torch.int8: np.dtype(np.int8),
          torch.bool: np.dtype(np.bool_)}
