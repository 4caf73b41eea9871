"""Column types — the port of ``h2o3_tpu/frame/types.py``.

Numeric data is float32 on the device (NaN = missing); categoricals are
int32 codes (-1 = missing) with a host-side string domain.
"""

from __future__ import annotations

import enum


class VecType(enum.Enum):
    BAD = "bad"        # all-missing column
    NUM = "real"       # numeric (float32 on device)
    INT = "int"        # integer-valued numeric (still float32 on device)
    CAT = "enum"       # categorical: int32 codes + host domain
    TIME = "time"      # epoch millis
    STR = "string"     # host-resident string column
    UUID = "uuid"      # host-resident uuid column

    @property
    def is_numeric(self) -> bool:
        return self in (VecType.NUM, VecType.INT, VecType.TIME)

    @property
    def on_device(self) -> bool:
        return self in (VecType.NUM, VecType.INT, VecType.TIME, VecType.CAT)

    def __str__(self) -> str:  # matches h2o-py frame "types" display names
        return self.value


#: missing-value code of a categorical column
CAT_NA = -1
