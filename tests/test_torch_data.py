"""The port's host data layer (torchrecsys_tpu_torch/data) against the JAX
package's: id encoding, metadata tables, static negatives and
``prepare_data`` must agree bit for bit on the same numpy inputs.

The JAX package parses text int-list metadata ("[3, 7]") in two ways: its
native C++ parser encodes the values through a sorted ``np.unique``, its
Python fallback (used when ``_ingest.so`` cannot be built or loaded) in
first-seen order. The port always follows the native grammar. Where the
native library is unavailable in the JAX package, the tables that hold text
lists are held to sha256 digests recorded from the JAX package's native path.
"""

import hashlib

import numpy as np
import pytest

from torchrecsys_tpu import native as jnative
from torchrecsys_tpu.data import encoder as jenc
from torchrecsys_tpu.data import interactions as jint
from torchrecsys_tpu.data import metadata as jmeta
from torchrecsys_tpu.data import sampling as jsamp
from torchrecsys_tpu_torch.data import encoder as tenc
from torchrecsys_tpu_torch.data import interactions as tint
from torchrecsys_tpu_torch.data import metadata as tmeta
from torchrecsys_tpu_torch.data import sampling as tsamp


def _id_columns():
    r = np.random.default_rng(0)
    ints = r.choice([7, 3, 1000, 42, -5, 99], size=200)
    strs = np.asarray([f"u{v}" for v in r.integers(0, 30, 200)], dtype=object)
    objs = np.empty(200, dtype=object)
    objs[:] = [(int(v) % 4, "x") for v in r.integers(0, 50, 200)]
    return {"int": ints, "str": strs, "obj": objs}


@pytest.mark.parametrize("kind", ["int", "str", "obj"])
def test_encode_column_bit_exact(kind):
    col = _id_columns()[kind]
    codes, enc = tenc.encode_column(col)
    jcodes, jenc_ = jenc.encode_column(col)
    np.testing.assert_array_equal(codes, jcodes)
    assert codes.dtype == jcodes.dtype
    assert enc.to_list() == jenc_.to_list()
    assert [type(v) for v in enc.to_list()] == [type(v) for v in jenc_.to_list()]
    assert enc.decode(codes[:10]) == jenc_.decode(jcodes[:10])


def _meta_columns(n=300, seed=1):
    r = np.random.default_rng(seed)
    base = r.integers(0, 12, n)
    lists = np.empty(n, dtype=object)
    lists[:] = [[int(v), int(v) % 5, 100 + int(v) % 3][: 1 + int(v) % 3] for v in base]
    text = np.asarray([str([int(v) * 3, -int(v)]) for v in base], dtype=object)
    words = np.asarray([["red", "blue", "green"][int(v) % 3] for v in base], dtype=object)
    mixed = np.empty(n, dtype=object)
    mixed[:] = [None if v % 5 == 0 else (float("nan") if v % 5 == 1 else int(v)) for v in base]
    return {
        "scalar_int": base * 7 - 20,
        "lists": lists,
        "text_lists": text,
        "words": words,
        "mixed": mixed,
    }


def _table_digest(tab):
    """sha256 of a metadata table's ids and mask (shape, dtype, bytes) and
    its encoders' vocab lists."""
    h = hashlib.sha256()
    for a in (tab.ids, tab.mask):
        a = np.ascontiguousarray(a)
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    h.update(repr([e.to_list() for e in tab.encoders]).encode())
    return h.hexdigest()


# Recorded from the JAX package's native path (native.available() true):
# the metadata tables of the cases below that hold a text-list column.
_NATIVE_DIGESTS = {
    "text_lists": "c6cb12be34186ffec831c7508a2d63bbbf93ccd021fc2ea0bce472ad72502c52",
    "prepare_int": "8de877d0da45507f0680759e4cccd49b318825b836e696a983bbe137e964440f",
    "prepare_str": "2388f7bfcf749ba6ffa470875def91595ebf555fb651a46258f5429f8e057fde",
}


def _native_reference(key, table):
    """True where the JAX package's table is the reference (its native
    parser loaded); else hold ``table`` to the pinned native digest."""
    if jnative.available():
        return True
    assert _table_digest(table) == _NATIVE_DIGESTS[key], key
    return False


@pytest.mark.parametrize("name", list(_meta_columns()))
def test_metadata_table_bit_exact(name):
    r = np.random.default_rng(2)
    items = r.integers(0, 40, 300).astype(np.int32)
    col = _meta_columns()[name]
    t = tmeta.MetadataTable.build(items, 45, {name: col})
    if name == "text_lists" and not _native_reference(name, t):
        return
    j = jmeta.MetadataTable.build(items, 45, {name: col})
    np.testing.assert_array_equal(t.ids, j.ids)
    np.testing.assert_array_equal(t.mask, j.mask)
    assert t.names == j.names and t.vocab_sizes == j.vocab_sizes
    assert [e.to_list() for e in t.encoders] == [e.to_list() for e in j.encoders]


def test_parse_metadata_cell_matches():
    cells = [None, 3, "[3, 7]", "(1, 2)", "red", "[oops", [4, 5], (6,), np.array([8, 9]), float("nan"), " [ 1 ,2 ] "]
    for c in cells:
        assert tmeta.parse_metadata_cell(c) == jmeta.parse_metadata_cell(c), c


@pytest.mark.parametrize("avoid", [False, True])
def test_sample_negatives_np_bit_exact(avoid):
    pos = np.random.default_rng(3).integers(0, 50, 500).astype(np.int32)
    a = tsamp.sample_negatives_np(np.random.default_rng(9), pos, 50, avoid)
    b = jsamp.sample_negatives_np(np.random.default_rng(9), pos, 50, avoid)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype


def _dataset(kind):
    r = np.random.default_rng(4)
    n = 1500
    users = r.integers(0, 120, n)
    items = r.integers(0, 80, n)
    if kind == "str":
        users = np.asarray([f"user{u}" for u in users], dtype=object)
        items = np.asarray([f"sku-{i}" for i in items], dtype=object)
    data = {"uid": users, "iid": items}
    meta = _meta_columns(n, seed=5)
    data["cat"] = meta["scalar_int"]
    data["tags"] = meta["lists"]
    data["text"] = meta["text_lists"]
    return data


@pytest.mark.parametrize("kind", ["int", "str"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_prepare_data_bit_exact(kind, dynamic):
    data = _dataset(kind)
    kw = dict(
        user_id_col="uid", item_id_col="iid", metadata_id_col=["cat", "tags", "text"],
        split_ratio=0.75, dynamic_neg_sampling=dynamic, seed=11,
    )
    t = tint.prepare_data(data, **kw)
    j = jint.prepare_data(data, **kw)
    assert t.schema.to_dict() == j.schema.to_dict()
    for f in ("train_users", "train_items", "test_users", "test_items",
              "train_neg_items", "test_neg_items"):
        a, b = getattr(t, f), getattr(j, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
    if _native_reference(f"prepare_{kind}", t.metadata):
        np.testing.assert_array_equal(t.metadata.ids, j.metadata.ids)
        np.testing.assert_array_equal(t.metadata.mask, j.metadata.mask)
        assert _table_digest(t.metadata) == _table_digest(j.metadata)
    assert t.user_encoder.to_list() == j.user_encoder.to_list()
    assert t.item_encoder.to_list() == j.item_encoder.to_list()


def test_prepare_data_from_dataframe():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({k: v for k, v in _dataset("int").items() if k != "tags"})
    kw = dict(user_id_col="uid", item_id_col="iid", metadata_id_col=["cat"], seed=3)
    t = tint.prepare_data(df, **kw)
    j = jint.prepare_data(df, **kw)
    np.testing.assert_array_equal(t.train_items, j.train_items)
    np.testing.assert_array_equal(t.metadata.ids, j.metadata.ids)
