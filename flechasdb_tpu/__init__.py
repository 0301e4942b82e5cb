"""flechasdb-tpu: a serverless-friendly vector database on JAX accelerators.

A ground-up rebuild of the flechasdb IndexIVFPQ engine (IVF coarse
partitioning + product quantization with residual encoding) where every hot
loop — k-means++ seeding, Lloyd's iterations, ADC distance tables, PQ code
scans, top-k selection — runs as batched JAX/XLA/Pallas programs on the device,
while the storage format stays compatible with the reference: databases are
content-addressed, zlib-compressed protobuf artifacts that a stateless reader
can load lazily, partition by partition.

Public surface (mirrors the reference capability checklist, README.md:40-76):

* :class:`DatabaseBuilder` — build a database from a vector set.
* :class:`StreamingDatabaseBuilder` — build from an out-of-core source
  (memmap/h5py) larger than device or host memory.
* :class:`Database` — in-memory database: query + attributes.
* :func:`save_database` / :func:`load_database` — persist / lazy-load.
* :mod:`flechasdb_tpu.asyncdb` — asyncio load & query.
* :class:`LocalFileSystem` — pluggable content-addressed storage.
"""

from .attributes import AttributeTable, Attributes, AttributeValue
from .errors import (
    FlechasError,
    InvalidArgs,
    InvalidContext,
    InvalidData,
    IOError_,
    ProtobufError,
    VerificationFailure,
)

try:  # staged build-out: these land in later phases of the build plan
    from .build import Database, DatabaseBuilder, QueryResult
    from .filters import Eq, Exists, Filter, In, Range
    from .flat import (
        FlatDatabase,
        StoredFlatDatabase,
        load_flat_database,
        load_flat_database_async,
        save_flat_database,
    )
    from .catalog import load_labeled, publish_label, resolve_label
    from .io import FileSystem, LocalFileSystem
    from .metrics import VALID_METRICS
    from .objectstore import AsyncFsspecFileSystem, FsspecFileSystem
    from .serialize import save_database
    from .stored import StoredDatabase, load_database
    from .streaming import StreamingDatabaseBuilder
except ImportError:  # pragma: no cover
    pass

__version__ = "0.3.0"                  # keep in sync with pyproject.toml

__all__ = [
    "AsyncFsspecFileSystem",
    "AttributeTable",
    "Attributes",
    "AttributeValue",
    "Database",
    "DatabaseBuilder",
    "Eq",
    "Exists",
    "FileSystem",
    "Filter",
    "In",
    "Range",
    "FsspecFileSystem",
    "FlatDatabase",
    "FlechasError",
    "InvalidArgs",
    "InvalidContext",
    "InvalidData",
    "IOError_",
    "LocalFileSystem",
    "ProtobufError",
    "QueryResult",
    "StoredDatabase",
    "StoredFlatDatabase",
    "StreamingDatabaseBuilder",
    "VALID_METRICS",
    "VerificationFailure",
    "load_database",
    "load_labeled",
    "publish_label",
    "resolve_label",
    "load_flat_database",
    "load_flat_database_async",
    "save_database",
    "save_flat_database",
    "__version__",
]
