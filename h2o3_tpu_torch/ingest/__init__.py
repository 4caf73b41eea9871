"""Streaming ingest with compressed columns — the port of
``h2o3_tpu/ingest/``: the chunked parse whose host peak is O(chunk)
(:mod:`h2o3_tpu_torch.ingest.pipeline`) and the lossless column encodings
whose tensors are built on first use (:mod:`h2o3_tpu_torch.ingest.encode`
and ``Vec.from_compressed``). The Cleaner's spill of cold values is
:mod:`h2o3_tpu_torch.utils.cleaner`.

``frame.parse.import_file`` sends large or compressed files here behind
``H2O3TPU_INGEST_STREAMING`` (``auto`` streams gzip files and files over
``H2O3TPU_INGEST_STREAM_MIN_BYTES``; ``1`` every text file; ``0`` none).
"""

from h2o3_tpu_torch.ingest.encode import CompressedChunk, encode_column
from h2o3_tpu_torch.ingest.pipeline import (IngestStats, ParsePromoted,
                                            stream_import)

__all__ = ["CompressedChunk", "IngestStats", "ParsePromoted",
           "encode_column", "stream_import"]
