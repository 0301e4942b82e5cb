"""Valid-but-weird wire fuzzing.

``test_decode_robustness.py`` covers malformed/corrupted input; this file
covers the *legal-but-unusual* encodings proto3 permits and canonical
writers never emit:

* randomized field order (fields may appear in any order),
* unknown fields interleaved anywhere (must be skipped),
* UNPACKED repeated scalars (individually tagged varint/fixed32 records)
  and packed/unpacked mixes — segments concatenate in arrival order,
* duplicated scalar fields (proto3 last-wins).

Authority for expected values: the protoc-generated codec
(``tests/fixtures/wire_check.proto``), which implements the same merge
semantics as the reference's rust-protobuf runtime
(src/protos/mod.rs:13-65, src/protos/database.proto:6-123).  Every fuzzed
byte string is decoded by BOTH codecs and the results compared; the hand
codec's canonical re-encode is then round-tripped through protoc again.
Seeds are pinned — failures reproduce exactly.
"""

import importlib.util
import random
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from flechasdb_tpu.protos import (
    PAttributesLog,
    PDatabase,
    PEncodedVectorSet,
    PPartition,
    PVectorSet,
)

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def wc(tmp_path_factory):
    """The protoc-generated independent codec module."""
    if shutil.which("protoc") is None:
        pytest.skip("protoc not available")
    out = tmp_path_factory.mktemp("gen_fuzz")
    try:
        subprocess.run(
            ["protoc", f"--proto_path={FIXTURES}",
             f"--python_out={out}", "wire_check.proto"],
            check=True, capture_output=True)
    except subprocess.CalledProcessError as e:  # pragma: no cover
        pytest.skip(f"protoc failed: {e.stderr.decode()}")
    spec = importlib.util.spec_from_file_location(
        "wire_check_fuzz_pb2", out / "wire_check_pb2.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["wire_check_fuzz_pb2"] = mod
    try:
        spec.loader.exec_module(mod)
    except Exception as e:  # pragma: no cover - runtime/gencode mismatch
        pytest.skip(f"generated code unusable: {e}")
    return mod


# --- wire-segment builders (hand-crafted on purpose: the fuzz input must
# --- not come from the codec under test) -----------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _seg_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _seg_len(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _seg_fixed32_f(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", np.float32(value))


def _seg_fixed64(field: int, value: int) -> bytes:
    return _tag(field, 1) + int(value).to_bytes(8, "little")


def _unknown_segments(rng: random.Random, avoid: set) -> list:
    """Random well-formed fields with numbers the schema doesn't use."""
    segs = []
    for _ in range(rng.randrange(0, 4)):
        f = rng.choice([n for n in (5, 7, 15, 19, 63, 200) if n not in avoid])
        kind = rng.randrange(4)
        if kind == 0:
            segs.append(_seg_varint(f, rng.getrandbits(35)))
        elif kind == 1:
            segs.append(_seg_fixed64(f, rng.getrandbits(64)))
        elif kind == 2:
            segs.append(_tag(f, 5) + rng.getrandbits(32).to_bytes(4, "little"))
        else:
            segs.append(_seg_len(f, rng.randbytes(rng.randrange(0, 12))))
    return segs


def _scalar_with_decoys(rng: random.Random, field: int, value: int) -> list:
    """Scalar field possibly preceded by decoy occurrences (last wins —
    but segments are shuffled afterwards, so the protoc decode is the
    authority for which occurrence actually wins)."""
    segs = [_seg_varint(field, value)]
    for _ in range(rng.randrange(0, 2)):
        segs.append(_seg_varint(field, rng.getrandbits(20)))
    return segs


def _packed_u32(values) -> bytes:
    return b"".join(_varint(int(v)) for v in values)


def _packed_f32(values) -> bytes:
    return struct.pack(f"<{len(values)}f",
                       *np.asarray(values, np.float32).tolist())


def _repeated_u32_segments(rng: random.Random, field: int, values) -> list:
    """Random split of a repeated uint32 into packed runs and unpacked
    varint records (order within each segment preserved; shuffling then
    permutes segments, and protoc defines the resulting element order)."""
    segs = []
    i = 0
    while i < len(values):
        n = rng.randrange(1, len(values) - i + 1)
        chunk = values[i:i + n]
        if rng.random() < 0.5:
            segs.append(_seg_len(field, _packed_u32(chunk)))
        else:
            segs.extend(_seg_varint(field, int(v)) for v in chunk)
        i += n
    return segs


def _repeated_f32_segments(rng: random.Random, field: int, values) -> list:
    segs = []
    i = 0
    while i < len(values):
        n = rng.randrange(1, len(values) - i + 1)
        chunk = values[i:i + n]
        if rng.random() < 0.5:
            segs.append(_seg_len(field, _packed_f32(chunk)))
        else:
            segs.extend(_seg_fixed32_f(field, float(v)) for v in chunk)
        i += n
    return segs


def _uuid_segment(rng: random.Random, field: int) -> bytes:
    """A Uuid submessage, occasionally with a zero half (which canonical
    writers skip, dropping the record off the 20-byte fast path) or with
    reversed field order."""
    upper = 0 if rng.random() < 0.1 else rng.getrandbits(64)
    lower = 0 if rng.random() < 0.1 else rng.getrandbits(64)
    f1 = _seg_fixed64(1, upper) if upper else b""
    f2 = _seg_fixed64(2, lower) if lower else b""
    payload = f2 + f1 if rng.random() < 0.3 else f1 + f2
    return _seg_len(field, payload)


def _shuffled(rng: random.Random, segs: list) -> bytes:
    segs = list(segs)
    rng.shuffle(segs)
    return b"".join(segs)


# --- comparisons -----------------------------------------------------------

def _assert_evs_eq(h: PEncodedVectorSet, p) -> None:
    assert h.vector_size == p.vector_size
    np.testing.assert_array_equal(
        np.asarray(h.data, np.uint32), np.asarray(p.data, np.uint32))


def _assert_vs_eq(h: PVectorSet, p) -> None:
    assert h.vector_size == p.vector_size
    np.testing.assert_array_equal(       # bit-exact f32
        np.asarray(h.data, np.float32), np.asarray(p.data, np.float32))


def _assert_partition_eq(h: PPartition, p) -> None:
    assert h.vector_size == p.vector_size
    assert h.num_divisions == p.num_divisions
    np.testing.assert_array_equal(
        np.asarray(h.centroid, np.float32),
        np.asarray(p.centroid, np.float32))
    if p.HasField("encoded_vectors"):
        assert h.encoded_vectors is not None
        _assert_evs_eq(h.encoded_vectors, p.encoded_vectors)
    else:
        assert h.encoded_vectors is None
    ours = [(v.upper, v.lower) for v in h.vector_ids]
    theirs = [(v.upper, v.lower) for v in p.vector_ids]
    assert ours == theirs


def _assert_db_eq(h: PDatabase, p) -> None:
    assert h.vector_size == p.vector_size
    assert h.num_partitions == p.num_partitions
    assert h.num_divisions == p.num_divisions
    assert h.num_codes == p.num_codes
    assert h.partition_ids == list(p.partition_ids)
    assert h.partition_centroids_id == p.partition_centroids_id
    assert h.codebook_ids == list(p.codebook_ids)
    assert h.attributes_log_ids == list(p.attributes_log_ids)
    assert h.attribute_names == list(p.attribute_names)


def _assert_log_eq(h: PAttributesLog, p) -> None:
    assert h.partition_id == p.partition_id
    assert len(h.entries) == len(p.entries)
    for he, pe in zip(h.entries, p.entries):
        assert he.name_index == pe.name_index
        if pe.HasField("vector_id"):
            assert (he.vector_id.upper, he.vector_id.lower) == (
                pe.vector_id.upper, pe.vector_id.lower)
        if pe.HasField("value"):
            which = pe.value.WhichOneof("value")
            if which == "string_value":
                assert he.value.value == pe.value.string_value
            elif which == "uint64_value":
                assert he.value.value == pe.value.uint64_value


def _roundtrip(wc_cls, hand_cls, assert_eq, fuzzed: bytes) -> None:
    """fuzzed bytes → both codecs agree; hand re-encode → protoc agrees."""
    expected = wc_cls()
    expected.ParseFromString(fuzzed)
    ours = hand_cls.decode(fuzzed)
    assert_eq(ours, expected)
    # Canonical re-encode parses back identically through BOTH codecs
    # (byte-identity with protoc's re-serialize is not required: protoc
    # preserves and re-emits unknown fields, the hand codec drops them).
    re_bytes = ours.encode()
    re_theirs = wc_cls()
    re_theirs.ParseFromString(re_bytes)
    assert_eq(ours, re_theirs)
    assert_eq(hand_cls.decode(re_bytes), expected)


# --- the fuzz tests --------------------------------------------------------

SEEDS = list(range(40))


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_encoded_vector_set(wc, seed):
    rng = random.Random(1000 + seed)
    values = [rng.getrandbits(32) for _ in range(rng.randrange(0, 40))]
    segs = _repeated_u32_segments(rng, 10, values)
    segs += _scalar_with_decoys(rng, 1, rng.randrange(1, 64))
    segs += _unknown_segments(rng, avoid={1, 10})
    _roundtrip(wc.EncodedVectorSet, PEncodedVectorSet, _assert_evs_eq,
               _shuffled(rng, segs))


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_vector_set(wc, seed):
    rng = random.Random(2000 + seed)
    values = [rng.uniform(-10, 10) for _ in range(rng.randrange(0, 40))]
    segs = _repeated_f32_segments(rng, 10, values)
    segs += _scalar_with_decoys(rng, 1, rng.randrange(1, 64))
    segs += _unknown_segments(rng, avoid={1, 10})
    _roundtrip(wc.VectorSet, PVectorSet, _assert_vs_eq,
               _shuffled(rng, segs))


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_partition(wc, seed):
    rng = random.Random(3000 + seed)
    m = rng.randrange(1, 12)
    segs = _repeated_f32_segments(
        rng, 10, [rng.uniform(-1, 1) for _ in range(m)])
    segs += _scalar_with_decoys(rng, 1, m)
    segs += _scalar_with_decoys(rng, 2, rng.randrange(1, 8))
    # nested EncodedVectorSet — itself with unpacked/duplicated weirdness
    inner_rng = random.Random(seed)
    inner = _shuffled(inner_rng, _repeated_u32_segments(
        inner_rng, 10, [rng.getrandbits(8) for _ in range(6)])
        + [_seg_varint(1, 3)])
    segs.append(_seg_len(11, inner))
    segs += [_uuid_segment(rng, 12) for _ in range(rng.randrange(0, 6))]
    segs += _unknown_segments(rng, avoid={1, 2, 10, 11, 12})
    _roundtrip(wc.Partition, PPartition, _assert_partition_eq,
               _shuffled(rng, segs))


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_database(wc, seed):
    rng = random.Random(4000 + seed)
    segs = []
    for f in (1, 2, 3, 4):
        segs += _scalar_with_decoys(rng, f, rng.randrange(1, 1 << 16))
    for f in (10, 12, 13, 14):
        for _ in range(rng.randrange(0, 5)):
            s = "".join(rng.choice("0123456789abcdef")
                        for _ in range(rng.choice([4, 45, 130])))
            segs.append(_seg_len(f, s.encode()))
    segs.append(_seg_len(11, b"root-" + str(seed).encode()))
    # avoid 20/21: the hand codec knows those extension fields, the
    # wire_check schema doesn't — they are exercised by test_golden_ext.
    segs += _unknown_segments(rng, avoid={1, 2, 3, 4, 10, 11, 12, 13, 14,
                                          20, 21})
    _roundtrip(wc.Database, PDatabase, _assert_db_eq, _shuffled(rng, segs))


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_attributes_log(wc, seed):
    rng = random.Random(5000 + seed)
    segs = [_seg_len(1, b"part-" + str(seed).encode())]
    for _ in range(rng.randrange(0, 5)):
        e = [_uuid_segment(rng, 1), _seg_varint(2, rng.randrange(0, 100))]
        if rng.random() < 0.5:
            val = _seg_len(1, b"v" * rng.randrange(0, 8))
        else:
            val = _seg_varint(2, rng.getrandbits(40))
        e.append(_seg_len(3, val))
        e += _unknown_segments(rng, avoid={1, 2, 3})
        segs.append(_seg_len(10, _shuffled(rng, e)))
    segs += _unknown_segments(rng, avoid={1, 10})
    _roundtrip(wc.AttributesLog, PAttributesLog, _assert_log_eq,
               _shuffled(rng, segs))
