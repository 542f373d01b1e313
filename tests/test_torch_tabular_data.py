"""The tabular data side against the JAX package's, on the CPU: the ML block
stack (parser, recogniser, NaN handler, splitter, preprocessor, gather) on
one mixed table (float columns with NaN cells, strings, an integer-valued
column, a redundant column; classification, string and regression labels)
gives equal column types, category maps, fill values, split indices and
statistics, and equal arrays (exact: both are numpy, on numpy's global
generator); the loaders' batches under one seed; the transform and label
recovery of new rows; CSV parsing; `DataSplitter`'s stratified split; a data
folder either package saved loads in the other; the toy datasets. No model
is built here."""

import numpy as np
import pytest

import cflearn_torch  # noqa: F401
import cflearn_tpu.data.ml.api as jml
import cflearn_tpu.data.ml.datasets as jdatasets
from cflearn_torch.data.blocks import ml as tblocks
from cflearn_torch.data.ml import api as tml
from cflearn_torch.data.ml import datasets as tdatasets
from cflearn_torch.schema.data import DataBundle as TBundle
from cflearn_torch.schema.data import DataConfig, IData
from cflearn_torch.toolkit.serialization import Serializer
from cflearn_tpu.data.blocks import ml as jblocks
from cflearn_tpu.schema.data import DataBundle as JBundle
from cflearn_tpu.schema.data import DataConfig as JDataConfig
from cflearn_tpu.schema.data import IData as JIData
from cflearn_tpu.toolkit.serialization import Serializer as JSerializer

N = 61


def mixed_table(seed: int = 0, n: int = N) -> np.ndarray:
    """Two float columns (one with NaN cells), a string column, an
    integer-valued float column (categorical by the recogniser's bound), a
    string column of one value (redundant) and a wide-valued int column."""
    rs = np.random.RandomState(seed)
    x = np.empty((n, 6), dtype=object)
    x[:, 0] = rs.randn(n) * 3.0 + 1.0
    col = rs.randn(n)
    col[rs.rand(n) < 0.15] = np.nan
    x[:, 1] = col
    x[:, 2] = rs.choice(["red", "green", "blue", "amber"], n)
    x[:, 3] = rs.randint(0, 4, n).astype(np.float64)
    x[:, 4] = "constant"
    x[:, 5] = rs.randint(0, 50, n)
    return x


LABELS = {
    "classes": lambda rs, n: rs.randint(0, 3, (n, 1)),
    "strings": lambda rs, n: rs.choice(["no", "yes"], (n, 1)).astype(object),
    "regression": lambda rs, n: (rs.randn(n, 1) * 10.0 + 5.0),
}


def _fit(module, label: str, seed: int = 3, **data_kw):
    rs = np.random.RandomState(11)
    x = mixed_table()
    y = LABELS[label](rs, N)
    config = (JDataConfig if module is jml else DataConfig)()
    for k, v in data_kw.items():
        setattr(config, k, v)
    np.random.seed(seed)
    return module.MLData.init(config).fit(x, y)


def _block(data, cls_name: str):
    return next(b for b in data.processor.blocks if type(b).__name__ == cls_name)


BLOCK_FIELDS = {
    "RecognizerBlock": ("column_types", "categorical_maps", "index_mapping", "is_classification", "label_map"),
    "NanHandlerBlock": ("method", "fill_values"),
    "PreProcessorBlock": ("feature_stats", "label_stats", "skip_columns"),
    "GatherBlock": ("num_features", "num_labels", "num_classes", "is_classification"),
}


@pytest.mark.parametrize("label", sorted(LABELS))
def test_block_stack_matches_jax(label) -> None:
    j, t = _fit(jml, label), _fit(tml, label)
    assert [b.name for b in t.processor.blocks] == [b.name for b in j.processor.blocks]
    for cls_name, fields in BLOCK_FIELDS.items():
        jb, tb = _block(j, cls_name), _block(t, cls_name)
        for f in fields:
            assert getattr(tb, f) == getattr(jb, f), (cls_name, f)
    rec = _block(t, "RecognizerBlock")
    assert rec.column_types == {"0": "numerical", "1": "numerical", "2": "categorical", "3": "categorical",
                                "4": "redundant", "5": "numerical"}
    assert t.encoder_settings == j.encoder_settings == {"2": {"dim": 5}, "3": {"dim": 5}}
    for attr in ("x_train", "y_train", "x_valid", "y_valid"):
        a, b = getattr(t.bundle, attr), getattr(j.bundle, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    assert (t.num_features, t.num_labels, t.num_classes, t.is_classification) == (
        j.num_features, j.num_labels, j.num_classes, j.is_classification)
    assert t.num_train == j.num_train and t.num_valid == j.num_valid


@pytest.mark.parametrize("label", sorted(LABELS))
def test_loaders_transform_and_recovery_match_jax(label) -> None:
    j, t = _fit(jml, label, batch_size=16), _fit(tml, label, batch_size=16)
    for seed in (1, 2):
        np.random.seed(seed)
        jt, jv = j.get_loaders()
        jbatches = list(jt) + list(jv)
        np.random.seed(seed)
        tt, tv = t.get_loaders()
        tbatches = list(tt) + list(tv)
        assert len(jbatches) == len(tbatches)
        for a, b in zip(tbatches, jbatches):
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k
    # new rows, with a category and a string never seen in the fit
    new = mixed_table(seed=5, n=9)
    new[0, 2] = "violet"
    new[1, 3] = 7.0
    tb, jb = t.transform(new), j.transform(new)
    assert np.array_equal(tb.x_train, jb.x_train) and tb.x_train.dtype == jb.x_train.dtype
    y = np.linspace(-1.0, 2.0, 9, dtype=np.float32)[:, None]
    if label != "regression":
        y = np.arange(9)[:, None] % 2
    assert np.array_equal(t.recover_labels(y), j.recover_labels(y))


def test_csv_parsing_and_inference_files_match_jax(tmp_path) -> None:
    """A CSV with a header, its label the last column: the same arrays, the
    header, the label index; a feature-only file at inference."""
    rs = np.random.RandomState(4)
    rows = [["f0", "f1", "colour", "label"]]
    for _ in range(40):
        rows.append([f"{rs.randn():.4f}", "" if rs.rand() < 0.1 else f"{rs.randn():.3f}",
                     rs.choice(["a", "b", "c"]), str(rs.randint(0, 2))])
    path = tmp_path / "table.csv"
    path.write_text("\n".join(",".join(r) for r in rows) + "\n")
    feats = tmp_path / "features.csv"
    feats.write_text("\n".join(",".join(r[:3]) for r in rows) + "\n")
    outs = []
    for module in (jml, tml):
        np.random.seed(9)
        data = module.MLData.init().fit(str(path))
        parser = _block(data, "FileParserBlock")
        outs.append((data, parser.header, parser.label_index, parser.num_columns, data.transform(str(feats)).x_train))
    (j, jh, ji, jn, jx), (t, th, ti, tn, tx) = outs
    assert (th, ti, tn) == (jh, ji, jn) == (["f0", "f1", "colour"], 3, 4)
    for attr in ("x_train", "y_train", "x_valid", "y_valid"):
        assert np.array_equal(getattr(t.bundle, attr), getattr(j.bundle, attr)), attr
    assert np.array_equal(tx, jx) and tx.shape == (40, 3)


@pytest.mark.parametrize("labels", ["classes", "floats", "none"])
def test_data_splitter_matches_jax(labels) -> None:
    rs = np.random.RandomState(2)
    x = rs.randn(50, 3)
    y = {"classes": np.r_[np.zeros(30, int), np.ones(19, int), [2]][:, None], "floats": rs.randn(50, 1),
         "none": None}[labels]
    out = []
    for blocks in (jblocks, tblocks):
        np.random.seed(13)
        out.append(blocks.DataSplitter().split(x, y, 0.2))
    (jr, js), (tr, ts) = out
    assert np.array_equal(tr, jr) and np.array_equal(ts, js)
    if labels == "classes":
        # every class on both sides where it has two samples or more; the singleton goes to the split
        assert set(y[ts, 0]) == {0, 1, 2} and set(y[tr, 0]) == {0, 1}


@pytest.mark.parametrize("method", ["mean", "median", "most_frequent", "constant", "drop"])
def test_nan_handler_methods_match_jax(method) -> None:
    rs = np.random.RandomState(8)
    x = rs.randint(0, 5, (30, 3)).astype(np.float64)
    x[rs.rand(30, 3) < 0.2] = np.nan
    y = rs.randint(0, 2, (30, 1))
    xv = x[:6].copy()
    out = []
    for blocks in (jblocks, tblocks):
        block = blocks.NanHandlerBlock()
        block.method = method
        bundle = (JBundle if blocks is jblocks else TBundle)(x.copy(), y.copy(), xv.copy(), y[:6].copy())
        done = block.fit_transform(bundle)
        out.append((block.fill_values, done.x_train, done.y_train, done.x_valid))
    (jf, jx, jy, jv), (tf, tx, ty, tv) = out
    assert tf == jf
    for a, b in ((tx, jx), (ty, jy), (tv, jv)):
        assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("method", ["normalize", "min_max", "robust"])
def test_preprocessor_methods_and_label_recovery_match_jax(method) -> None:
    rs = np.random.RandomState(6)
    x = rs.randn(40, 3) * [1.0, 5.0, 0.1] + [0.0, 3.0, -2.0]
    y = rs.randn(40, 1) * 4.0
    out = []
    for blocks in (jblocks, tblocks):
        block = blocks.PreProcessorBlock()
        block.method = block.label_method = method
        done = block.fit_transform((JBundle if blocks is jblocks else TBundle)(x.copy(), y.copy()))
        out.append((block.feature_stats, block.label_stats, done.x_train, done.y_train,
                    block.recover_labels(done.y_train)))
    (jfs, jls, jx, jy, jr), (tfs, tls, tx, ty, tr) = out
    assert (tfs, tls) == (jfs, jls)
    for a, b in ((tx, jx), (ty, jy), (tr, jr)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_data_folders_load_across(tmp_path) -> None:
    """An `MLData` saved by either package loads in the other and transforms
    new rows alike (the fitted blocks' state goes across)."""
    j, t = _fit(jml, "strings"), _fit(tml, "strings")
    JSerializer.save(str(tmp_path / "j"), j, save_npd=False)
    Serializer.save(str(tmp_path / "t"), t, save_npd=False)
    t_from_j = Serializer.load(str(tmp_path / "j"), IData, load_npd=False)
    j_from_t = JSerializer.load(str(tmp_path / "t"), JIData, load_npd=False)
    assert isinstance(t_from_j, tml.MLData) and isinstance(j_from_t, jml.MLData)
    new = mixed_table(seed=12, n=7)
    want = j.transform(new).x_train
    for loaded in (t_from_j, j_from_t):
        assert np.array_equal(loaded.transform(new).x_train, want)
    labels = np.array([[0], [1], [1]])
    assert np.array_equal(t_from_j.recover_labels(labels), j.recover_labels(labels))
    assert t_from_j.encoder_settings == j.encoder_settings


def test_processor_configs_and_names_match_jax() -> None:
    for name in ("MLProcessorConfig", "MLBundledProcessorConfig", "MLAdvancedProcessorConfig"):
        jc, tc = getattr(jml, name)(), getattr(tml, name)()
        assert [b.name for b in tc.default_blocks] == [b.name for b in jc.default_blocks]
    assert tml.MLDataConfig().batch_size == jml.MLDataConfig().batch_size == 128
    assert tml.MLBatch._fields == jml.MLBatch._fields
    assert tml.MLDatasetTag.VALID.value == jml.MLDatasetTag.VALID.value
    assert {f for f in tml.MLFileProcessorConfig.__dataclass_fields__} == {
        f for f in jml.MLFileProcessorConfig.__dataclass_fields__}
    for enum in ("DataTypes", "ColumnTypes", "DataOrder", "NanReplaceMethod", "NanDropStrategy", "PreProcessMethods"):
        assert [e.value for e in getattr(tblocks, enum)] == [e.value for e in getattr(jblocks, enum)]
    for dc in ("MLNanHandlerConfig", "MLRecognizerConfig", "MLSplitterConfig", "MLPreProcessConfig"):
        assert list(getattr(tblocks, dc).__dataclass_fields__) == list(getattr(jblocks, dc).__dataclass_fields__)


def test_toy_datasets_match_jax() -> None:
    """The scikit-learn loaders, and MNIST's fallback (the digits upscaled by
    the port's resize against `jax.image.resize`: f32, 1e-6)."""
    for name in ("iris_data", "breast_data"):
        (tx, ty), (jx, jy) = getattr(tdatasets, name)(), getattr(jdatasets, name)()
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy) and ty.dtype == jy.dtype
    (tx, ty), (jx, jy) = tdatasets.mnist_data(img_size=28), jdatasets.mnist_data(img_size=28)
    assert tx.shape == jx.shape == (1797, 28, 28, 1) and np.array_equal(ty, jy)
    assert np.abs(tx - jx).max() <= 1e-6
