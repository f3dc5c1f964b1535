"""Shared basic types.

Capability parity: vkit/utility/type.py:14-17 (PathType).
"""
import os
from typing import Union

PathType = Union[str, os.PathLike]
