"""The port's compressed column encodings (``h2o3_tpu_torch/ingest/
encode.py``) against the JAX package's (``h2o3_tpu/ingest/encode.py``):
the same float32 or code arrays, made from a numpy seed, get the same
codec, payload dtype, payload, bias and raw bytes, and decode to the same
bits (exact). The port's ``to_tensor``, which widens the narrow payload on
the tensor's device, equals its host ``decode`` bit for bit (on the CPU
in these tests; ``chip_smoke.py`` phase 16 holds it on the card)."""

import numpy as np
import pytest
import torch

from h2o3_tpu.ingest import encode as jenc
from h2o3_tpu_torch.ingest import encode as penc
from jax_reference import _jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _numeric_cases():
    rng = np.random.default_rng(5)
    small = rng.integers(-40, 90, 500).astype(np.float32)
    small[::17] = np.nan
    return {
        "i8_with_na": small,
        "i16_span": np.arange(0, 40000, 13, dtype=np.float32),
        "i16_negative": rng.integers(-30000, 2000, 300).astype(np.float32),
        "fractional": rng.normal(size=200).astype(np.float32),
        "past_2_24": np.array([2.0**25, 2.0**25 + 2, np.nan], np.float32),
        "wide_integral": (np.arange(20000) * 7).astype(np.float32),
        "all_na": np.full(10, np.nan, np.float32),
        "with_inf": np.array([1, 2, np.inf, 4], np.float32),
        "hhmm": (rng.integers(5, 24, 400) * 100
                 + rng.integers(0, 60, 400)).astype(np.float32),
    }


def _same_chunk(jc, pc):
    assert pc.codec == jc.codec
    assert pc.payload.dtype == jc.payload.dtype
    np.testing.assert_array_equal(pc.payload, jc.payload)
    assert pc.bias == jc.bias and pc.raw_bytes == jc.raw_bytes
    assert pc.nbytes == jc.nbytes and pc.nrows == jc.nrows
    a, b = pc.decode(), jc.decode()
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name", list(_numeric_cases()))
def test_encode_numeric_equals_reference(name):
    v = _numeric_cases()[name]
    pc = penc.encode_numeric(v)
    _same_chunk(jenc.encode_numeric(v), pc)
    t = pc.to_tensor(torch.device("cpu"))
    np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                  pc.decode().view(np.uint8))


@pytest.mark.parametrize("card,codec", [(3, "dict8"), (128, "dict8"),
                                        (129, "dict16"), (300, "dict16"),
                                        (70000, "dict32")])
def test_encode_codes_equals_reference(card, codec):
    rng = np.random.default_rng(card)
    codes = rng.integers(-1, card, 400).astype(np.int32)
    pc = penc.encode_codes(codes, card)
    assert pc.codec == codec
    _same_chunk(jenc.encode_codes(codes, card), pc)
    t = pc.to_tensor(torch.device("cpu"))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), codes)


def test_concat_chunks_reencodes_like_reference():
    """Two chunks that each fit i8 under their own bias fuse into i16, and
    a categorical column fuses at its whole cardinality."""
    a = np.arange(0, 200, dtype=np.float32)
    b = np.arange(1000, 1200, dtype=np.float32)
    pch = [penc.encode_numeric(a), penc.encode_numeric(b)]
    jch = [jenc.encode_numeric(a), jenc.encode_numeric(b)]
    assert [c.codec for c in pch] == ["i8", "i8"]
    _same_chunk(jenc.concat_chunks(jch), penc.concat_chunks(pch))
    codes = [np.array([0, 1, -1], np.int32), np.array([2, 0], np.int32)]
    pc = penc.concat_chunks([penc.encode_codes(c, 3) for c in codes],
                            is_categorical=True, cardinality=400)
    jc = jenc.concat_chunks([jenc.encode_codes(c, 3) for c in codes],
                            is_categorical=True, cardinality=400)
    _same_chunk(jc, pc)
    single = penc.encode_numeric(a)
    assert penc.concat_chunks([single]) is single


def test_encode_column_dispatch_and_repr():
    v = np.array([1, 2, 3], np.float32)
    assert penc.encode_column(v).codec == "i8"
    assert penc.encode_column(np.array([0, 1], np.int32), True, 2).codec \
        == "dict8"
    assert "i8" in repr(penc.encode_column(v))
