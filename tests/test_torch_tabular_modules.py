"""The tabular modules against the JAX package's, on the CPU at tiny sizes:
the mappings ("basic", "highway", "res"), `customs.py` (the pruned `Linear`,
`Pruner`, `DNDF`, `DropPath`, `leaf_aggregation`, `route`), the categorical
`Encoder`, "linear", "fcnn", the token mixers "fourier", "mlp", "pool",
"rwkv", the channel mixers "rwkv" and "moe" (its top-k ties and capacity
drops, its load-balancing loss), `BertPooler`, `SequencePooler`, and the nets
"wnd", "rnn" (GRU and LSTM, one and two directions), "fnet", "mixer",
"transformer", "pool_former", "dndf", "nbm", "ndt" (and `from_sklearn_tree`)
and "ddr" with its loss.

Each JAX module is built abstractly and filled from numpy (`fast_build`),
its state carried across by the bridge, strict both ways, and both sides
called on the same numpy inputs in eval and in training mode. A module
with BatchNorm on (B, d) features is also run through three training-mode
calls on different batches: its running mean and variance (flax's momentum
0.99 and biased variance) are compared after them. f32 throughout: F32 (1e-5
of the reference's largest magnitude) covers another summation order; the
tolerances that differ are stated at their tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import cflearn_torch  # noqa: F401
from _torch_bridge_common import rel_err
from _torch_cv_common import F32, fast_build, jax_state, pair, rand
from cflearn_torch.modules.core import customs as TCu
from cflearn_torch.modules.core import mappings as TMap
from cflearn_torch.modules.core import mixed_stacks as TMS
from cflearn_torch.modules.core import ml_encoder as TEnc
from cflearn_torch.modules.ml import ddr as TDdr
from cflearn_torch.modules.ml import fcnn as TF
from cflearn_torch.modules.ml import linear as TL
from cflearn_torch.modules.ml import nets as TN
from cflearn_torch.schema.model import aux_losses
from cflearn_tpu.modules.core import customs as JCu
from cflearn_tpu.modules.core import mappings as JMap
from cflearn_tpu.modules.core import mixed_stacks as JMS
from cflearn_tpu.modules.core import ml_encoder as JEnc
from cflearn_tpu.modules.ml import ddr as JDdr
from cflearn_tpu.modules.ml import fcnn as JF
from cflearn_tpu.modules.ml import linear as JL
from cflearn_tpu.modules.ml import nets as JN
from cflearn_tpu.schema.model import AuxLossVariable as JAux


def _constants(path):
    """The non-parameter variables `fast_build` cannot draw: DNDF's tree
    masks and the MoE mixer's recorded objective."""
    leaf = path[-1]
    if leaf in ("_path", "_sign"):
        return None
    if leaf == "aux_loss":
        return np.zeros((), np.float32)
    raise KeyError(path)


def build_pair(j_ctor, t_ctor, seed: int = 3):
    """(JAX module, port module with its state). DNDF's masks are taken
    from a concrete JAX build (they are fixed), the rest filled by
    `fast_build`."""
    concrete = {}

    def constants(path):
        value = _constants(path)
        if value is None:
            if not concrete:
                concrete.update(jax_state(j_ctor(nnx.Rngs(0))))
            return concrete["/".join(map(str, path))]
        return value

    jm = fast_build(lambda: j_ctor(nnx.Rngs(seed)), seed=seed, constants=constants)
    return jm, pair(jm, t_ctor())


def run_both(jm, tm, *arrays, training: bool = False, **kwargs):
    """Both modules on the same numpy inputs, the JAX one called eagerly."""
    (jm.train if training else jm.eval)()
    tm.train(training)
    ref = jm(*(jnp.asarray(a) for a in arrays), **kwargs)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(np.asarray(a)) for a in arrays), **kwargs)
    return got, ref


def close(got, ref, tol: float = F32, what: str = "") -> None:
    if isinstance(ref, dict):
        for k in ref:
            close(got[k], ref[k], tol, f"{what}.{k}")
        return
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert rel_err(got, ref) < tol, (what, rel_err(got, ref))


def stats_close(jm, tm, tol: float = 1e-6) -> int:
    """The BatchNorm running statistics of both sides agree; returns how many."""
    stats = {k: v for k, v in jax_state(jm).items() if k.endswith(("/mean", "/var"))}
    buffers = {k.replace(".", "/"): v for k, v in tm.state_dict().items()}
    for k, v in stats.items():
        assert rel_err(buffers[k].numpy(), v) < tol, k
    return len(stats)


# ---------------------------------------------------------------- mappings and customs


MAPPINGS = {
    "basic": (lambda r: JMap.MappingBlock(5, 7, rngs=r), lambda: TMap.MappingBlock(5, 7)),
    "basic_layer_norm": (lambda r: JMap.MappingBlock(5, 7, norm_type="layer_norm", activation="mish", rngs=r),
                         lambda: TMap.MappingBlock(5, 7, norm_type="layer_norm", activation="mish")),
    "highway": (lambda r: JMap.HighwayBlock(5, 7, rngs=r), lambda: TMap.HighwayBlock(5, 7)),
    # the JAX "res" block builds only at in_dim == out_dim (its `to_out = None` before the Linear is refused by
    # nnx), so both cases keep the width; `test_res_mapping_widens` holds the port's widening block to a plain
    # reference
    "res": (lambda r: JMap.ResBlock(7, 7, rngs=r), lambda: TMap.ResBlock(7, 7)),
    "res_no_norm": (lambda r: JMap.ResBlock(7, 7, norm_type=None, rngs=r), lambda: TMap.ResBlock(7, 7, norm_type=None)),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", sorted(MAPPINGS))
def test_mappings_match_jax(case, training) -> None:
    """Each mapping in eval mode (running statistics) and in training mode
    (batch statistics): F32; in training mode three calls on three batches,
    then the running statistics: 1e-6."""
    jm, tm = build_pair(*MAPPINGS[case])
    for i in range(3 if training else 1):
        got, ref = run_both(jm, tm, rand(10 + i, 9, 7 if case.startswith("res") else 5), training=training)
        close(got, ref, what=case)
    if training and "norm" not in case:
        assert stats_close(jm, tm) > 0
    assert TMap.mappings.all == JMap.mappings.all


def _plain_res_block(block, x, training):
    """The "res" mapping in float64 numpy from `block`'s own weights: the
    widening Linear, two Linear -> BatchNorm (flax's: biased batch variance,
    running statistics moved by 0.99) mappings, the first with ReLU, the skip,
    ReLU. Returns the output and the running (mean, var) of each norm after
    the call."""
    w = {k: v.detach().double().numpy() for k, v in block.state_dict().items()}

    def linear(name, h):
        return h @ w[f"{name}.weight"].T + w[f"{name}.bias"]

    stats = {}

    def norm(name, h):
        if f"{name}.mean" not in w:
            return h
        mean, var = w[f"{name}.mean"], w[f"{name}.var"]
        if training:
            mean_b, var_b = h.mean(0), (h * h).mean(0) - h.mean(0) ** 2
            stats[name] = (0.99 * mean + 0.01 * mean_b, 0.99 * var + 0.01 * var_b)
            mean, var = mean_b, var_b
        return (h - mean) / np.sqrt(var + 1e-5) * w[f"{name}.weight"] + w[f"{name}.bias"]

    x = linear("to_out", x.astype(np.float64))
    net = np.maximum(norm("block1.norm", linear("block1.linear", x)), 0.0)
    net = norm("block2.norm", linear("block2.linear", net))
    return np.maximum(x + net, 0.0), stats


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("norm_type", ["batch_norm", None])
def test_res_mapping_widens(norm_type, training) -> None:
    """The "res" mapping at in_dim != out_dim (5 -> 7), which the JAX block
    cannot build, against a plain float64 reference on its own weights; in
    training mode three calls, each followed by the running statistics. Then
    "fcnn" with `mapping_type="res"` through widths 5 -> 8 -> 6 runs and
    yields finite logits. F32 of the reference's largest value."""
    torch.manual_seed(0)
    block = TMap.ResBlock(5, 7, norm_type=norm_type).train(training)
    assert block.to_out is not None
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.5)
    for i in range(3 if training else 1):
        x = rand(20 + i, 9, 5)
        want, stats = _plain_res_block(block, x, training)
        with torch.no_grad():
            got = block(torch.from_numpy(x))
        close(got, want, what="res 5 -> 7")
        for name, (mean, var) in stats.items():
            close(getattr(block.get_submodule(name), "mean"), mean, 1e-6, f"{name}.mean")
            close(getattr(block.get_submodule(name), "var"), var, 1e-6, f"{name}.var")
        assert len(stats) == (2 if training and norm_type else 0)
    net = TF.FCNN(5, 3, [8, 6], mapping_type="res", norm_type=norm_type).train(training)
    out = net(torch.from_numpy(rand(30, 9, 5)))
    assert out.shape == (9, 3) and bool(torch.isfinite(out).all())


def test_customs_match_jax() -> None:
    """The pruned `Linear` (and `Pruner` on its own), DNDF with class
    leaves, regression leaves and no leaves (the routes), `leaf_aggregation`
    and `route`: F32."""
    x = rand(1, 6, 5)
    cases = [
        (lambda r: JCu.Linear(5, 4, pruner_config={"alpha": 0.3}, rngs=r), lambda: TCu.Linear(5, 4, pruner_config={})),
        (lambda r: JCu.Linear(5, 4, rngs=r), lambda: TCu.Linear(5, 4)),
        (lambda r: JCu.DNDF(5, 3, num_tree=4, tree_depth=3, rngs=r), lambda: TCu.DNDF(5, 3, num_tree=4, tree_depth=3)),
        (lambda r: JCu.DNDF(5, 1, num_tree=2, tree_depth=2, rngs=r), lambda: TCu.DNDF(5, 1, num_tree=2, tree_depth=2)),
        (lambda r: JCu.DNDF(5, None, num_tree=3, tree_depth=2, rngs=r), lambda: TCu.DNDF(5, None, num_tree=3, tree_depth=2)),
    ]
    for j_ctor, t_ctor in cases:
        jm, tm = build_pair(j_ctor, t_ctor)
        got, ref = run_both(jm, tm, x)
        close(got, ref, what=type(jm).__name__)
    w = rand(2, 5, 4)
    jp, tp = build_pair(lambda r: JCu.Pruner({"beta": 2.0}, rngs=r), lambda: TCu.Pruner({"beta": 2.0}))
    close(tp(torch.from_numpy(w)), jp(jnp.asarray(w)), what="pruner")
    planes, leaves = rand(3, 4, 2, 7), rand(4, 8, 3)
    masks = TCu.tree_masks(3)
    path, sign = np.asarray(JCu.DNDF(2, 3, tree_depth=3, rngs=nnx.Rngs(0))._path[...]), masks[1]
    assert np.array_equal(masks[0], path)
    close(TCu.route(*(torch.from_numpy(a) for a in (planes, masks[0], sign))),
          JCu.route(*(jnp.asarray(a) for a in (planes, masks[0], sign))), what="route")
    net = rand(5, 6, 8)
    close(TCu.leaf_aggregation(torch.from_numpy(net), torch.from_numpy(leaves)),
          JCu.leaf_aggregation(jnp.asarray(net), jnp.asarray(leaves)), what="leaf_aggregation")


def test_dndf_init_and_drop_path() -> None:
    """A DNDF built by the port: its masks are the JAX module's, its leaves in
    [0, 1); `DropPath` is the identity in eval mode and keeps each sample
    whole or zero (scaled by 1 / keep) in training mode."""
    from cflearn_torch.modules.common import build_module, init_parameters

    tm = TCu.DNDF(4, 3, num_tree=5, tree_depth=3)
    init_parameters(tm, seed=1)
    jm = JCu.DNDF(4, 3, num_tree=5, tree_depth=3, rngs=nnx.Rngs(0))
    assert np.array_equal(tm._path.numpy(), np.asarray(jm._path[...]))
    assert np.array_equal(tm._sign.numpy(), np.asarray(jm._sign[...]))
    assert 0.0 <= tm.leaves.min().item() and tm.leaves.max().item() < 1.0 and tm.leaves.std().item() > 0.2
    dndf = build_module("dndf", config=dict(input_dim=4, output_dim=3, num_tree=5, tree_depth=3), device="cpu")
    assert torch.equal(dndf.dndf._path, tm._path)
    drop = TCu.DropPath(0.5)
    x = torch.randn(64, 3, 2)
    assert torch.equal(drop.eval()(x), x)
    out = drop.train()(x)
    kept = (out != 0).flatten(1).all(1)
    assert torch.equal(out[kept], 2.0 * x[kept]) and not out[~kept].any() and 0 < int(kept.sum()) < 64


# ---------------------------------------------------------------- the encoder


ENCODERS = {
    "embedding": dict(columns={"1": {"dim": 4}, "3": {"dim": 6}}),
    "one_hot_and_embedding": dict(columns={"0": {"dim": 3, "methods": "one_hot"}, "2": {"dim": 5, "dim_embed": 3}}),
    "global_dim": dict(columns={"1": {"dim": 4}, "2": {"dim": 7}}, embedding_dim=5),
}


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoder_matches_jax(case) -> None:
    """Numerical, one-hot and embedding parts and the merge, on indices that
    run past each table (clipped) and below zero: exact (a lookup and a
    copy)."""
    kw = ENCODERS[case]
    jm, tm = build_pair(lambda r: JEnc.Encoder(rngs=r, **kw), lambda: TEnc.Encoder(**kw))
    rs = np.random.RandomState(2)
    x = rs.randn(7, 4).astype(np.float32)
    for col, setting in kw["columns"].items():
        x[:, int(col)] = rs.randint(-1, setting["dim"] + 2, 7)
    got, ref = run_both(jm, tm, x)
    for part in ("numerical", "one_hot", "embedding", "merged"):
        a, b = getattr(got, part), getattr(ref, part)
        assert (a is None) == (b is None), part
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), part
    assert (tm.dim_increment, tm.encoded_dim, tm.categorical_columns) == (
        jm.dim_increment, jm.encoded_dim, jm.categorical_columns)
    assert [TEnc.auto_embedding_dim(n) for n in (1, 2, 40, 10**6)] == [
        JEnc.auto_embedding_dim(n) for n in (1, 2, 40, 10**6)]
    none = TEnc.ml_encode(None, torch.from_numpy(x))
    assert none.one_hot is None and none.embedding is None and torch.equal(none.merged, torch.from_numpy(x))
    assert torch.equal(TEnc.ml_encode(tm, torch.from_numpy(x)).merged, got.merged)
    r = TEnc.EncodingResult(None, None, torch.ones(2, 3))
    assert torch.equal(r.merged, torch.ones(2, 3)) and TEnc.EncodingResult(None, None, None).merged is None


# ---------------------------------------------------------------- mixers and poolers


TOKEN_MIXERS = {
    "fourier": (lambda r: JMS.FourierTokenMixer(6, 9, 12, rngs=r), lambda: TMS.FourierTokenMixer(6, 9, 12)),
    "mlp": (lambda r: JMS.MLPTokenMixer(6, 9, 12, rngs=r), lambda: TMS.MLPTokenMixer(6, 9, 12)),
    "pool": (lambda r: JMS.PoolTokenMixer(6, 9, 12, rngs=r), lambda: TMS.PoolTokenMixer(6, 9, 12)),
    "pool_5": (lambda r: JMS.PoolTokenMixer(6, 9, 12, pool_size=5, rngs=r),
               lambda: TMS.PoolTokenMixer(6, 9, 12, pool_size=5)),
    "rwkv": (lambda r: JMS.RWKVTokenMixer(6, 9, 12, rngs=r), lambda: TMS.RWKVTokenMixer(6, 9, 12)),
    "rwkv_channel": (lambda r: JMS.RWKVChannelMixer(6, 12, rngs=r), lambda: TMS.RWKVChannelMixer(6, 12)),
}


@pytest.mark.parametrize("case", sorted(TOKEN_MIXERS))
def test_token_and_rwkv_mixers_match_jax(case) -> None:
    """(B, 9 tokens, 6): F32. The FFT's real part is compared to 1e-5 too
    (two FFT libraries); the rwkv recurrence runs unstabilised on both
    sides."""
    jm, tm = build_pair(*TOKEN_MIXERS[case])
    got, ref = run_both(jm, tm, rand(4, 3, 9, 6))
    close(got, ref, what=case)


MOE = {
    "default": dict(num_experts=4, top_k=2),
    "top1_tight": dict(num_experts=3, top_k=1, capacity_factor=0.5),
    "top3_overflow": dict(num_experts=4, top_k=3, capacity_factor=0.3),
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", sorted(MOE))
def test_moe_mixer_matches_jax(case, ties) -> None:
    """The MoE channel mixer: outputs (F32) and the load-balancing loss
    (1e-6), with random routing and with a zero router (every score tied:
    the lower expert index wins each round, and the capacity drops tokens in
    the same order)."""
    kw = MOE[case]
    jm, tm = build_pair(lambda r: JMS.MoEChannelMixer(6, 10, rngs=r, **kw), lambda: TMS.MoEChannelMixer(6, 10, **kw))
    if ties:
        jm.router.kernel[...] = jnp.zeros_like(jm.router.kernel[...])
        with torch.no_grad():
            tm.router.weight.zero_()
    x = rand(7, 3, 8, 6)
    got, ref = run_both(jm, tm, x, training=True)
    close(got, ref, what=case)
    (aux,) = aux_losses(tm)
    jaux = [v[...] for _, v in nnx.to_flat_state(nnx.state(jm, JAux))]
    assert abs(aux.item() - float(jaux[0])) <= 1e-6 * max(1.0, abs(float(jaux[0])))
    if ties and kw["top_k"] == 1:
        # every token chose expert 0, which keeps the first ceil(24 x 0.5 / 3) = 4: the rest are dropped (zero out)
        dropped = (got.reshape(-1, 6).abs().sum(-1) == 0).nonzero()[:, 0].tolist()
        assert dropped == list(range(4, 24))


def test_poolers_and_registries_match_jax() -> None:
    """`BertPooler`, `SequencePooler` with and without aux heads: F32; the
    registries hold the JAX package's mixers."""
    x = rand(5, 3, 7, 6)
    for j_ctor, t_ctor in (
        (lambda r: JMS.BertPooler(6, rngs=r), lambda: TMS.BertPooler(6)),
        (lambda r: JMS.SequencePooler(6, rngs=r), lambda: TMS.SequencePooler(6)),
        (lambda r: JMS.SequencePooler(6, ["a", "b"], rngs=r), lambda: TMS.SequencePooler(6, ["a", "b"])),
    ):
        jm, tm = build_pair(j_ctor, t_ctor)
        got, ref = run_both(jm, tm, x)
        close(got, ref, what=type(jm).__name__)
    assert set(TMS.token_mixers.all) == set(JMS.token_mixers.all)
    assert set(TMS.channel_mixers.all) == set(JMS.channel_mixers.all)


# ---------------------------------------------------------------- the nets


NETS = {
    "linear": (lambda r: JL.LinearModule(5, 3, rngs=r), lambda: TL.LinearModule(5, 3), (8, 5)),
    "fcnn": (lambda r: JF.FCNN(5, 3, [8, 6], rngs=r), lambda: TF.FCNN(5, 3, [8, 6]), (8, 5)),
    "fcnn_highway_dropout": (
        lambda r: JF.FCNN(5, 3, [8], mapping_type="highway", dropout=0.0, rngs=r),
        lambda: TF.FCNN(5, 3, [8], mapping_type="highway"), (8, 5)),
    "fcnn_res": (lambda r: JF.FCNN(6, 2, [6, 6], mapping_type="res", rngs=r),
                 lambda: TF.FCNN(6, 2, [6, 6], mapping_type="res"), (8, 6)),
    "wnd": (lambda r: JN.WideAndDeep(5, 3, [8], wide_dim=2, rngs=r), lambda: TN.WideAndDeep(5, 3, [8], wide_dim=2),
            (8, 5)),
    "fnet": (lambda r: JN.FNet(9, 3, num_layers=2, latent_dim=8, rngs=r),
             lambda: TN.FNet(9, 3, num_layers=2, latent_dim=8), (4, 9)),
    "mixer": (lambda r: JN.Mixer(9, 3, num_layers=2, latent_dim=8, rngs=r),
              lambda: TN.Mixer(9, 3, num_layers=2, latent_dim=8), (4, 9)),
    "transformer": (lambda r: JN.TabTransformer(9, 3, num_layers=2, latent_dim=16, rngs=r),
                    lambda: TN.TabTransformer(9, 3, num_layers=2, latent_dim=16), (4, 9)),
    "transformer_moe": (
        lambda r: JN.TabTransformer(9, 3, num_layers=1, latent_dim=16, channel_mixing_type="moe", rngs=r),
        lambda: TN.TabTransformer(9, 3, num_layers=1, latent_dim=16, channel_mixing_type="moe"), (4, 9)),
    "pool_former": (lambda r: JN.PoolFormer(9, 3, num_layers=2, latent_dim=8, rngs=r),
                    lambda: TN.PoolFormer(9, 3, num_layers=2, latent_dim=8), (4, 9)),
    "rwkv_stack": (
        lambda r: JN.MixedStackedModule(9, 3, token_mixing_type="rwkv", channel_mixing_type="rwkv", num_layers=1,
                                        latent_dim=8, rngs=r),
        lambda: TN.MixedStackedModule(9, 3, token_mixing_type="rwkv", channel_mixing_type="rwkv", num_layers=1,
                                      latent_dim=8), (4, 9)),
    "transformer_3d_input": (lambda r: JN.TabTransformer(12, 2, num_layers=1, latent_dim=8, rngs=r),
                             lambda: TN.TabTransformer(12, 2, num_layers=1, latent_dim=8), (4, 3, 4)),
    "dndf": (lambda r: JN.DNDFModule(5, 3, num_tree=3, tree_depth=2, rngs=r),
             lambda: TN.DNDFModule(5, 3, num_tree=3, tree_depth=2), (8, 5)),
    "nbm": (lambda r: JN.NBM(4, 2, num_bases=6, hidden_units=[8], rngs=r),
            lambda: TN.NBM(4, 2, num_bases=6, hidden_units=[8]), (8, 4)),
    "nbm_pairwise": (lambda r: JN.NBM(4, 2, num_bases=6, hidden_units=[8], use_pairwise=True, rngs=r),
                     lambda: TN.NBM(4, 2, num_bases=6, hidden_units=[8], use_pairwise=True), (8, 4)),
    "ndt": (lambda r: JN.NDT(5, 3, rngs=r), lambda: TN.NDT(5, 3), (8, 5)),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", sorted(NETS))
def test_nets_match_jax(case, training) -> None:
    """Each net in eval and training mode: F32; where it holds BatchNorms
    ("fcnn", "wnd"), its running statistics after three training-mode calls
    on three batches: 1e-6."""
    j_ctor, t_ctor, shape = NETS[case]
    jm, tm = build_pair(j_ctor, t_ctor)
    for i in range(3 if training else 1):
        got, ref = run_both(jm, tm, rand(20 + i, *shape), training=training)
        close(got, ref, what=case)
    if training and case.startswith(("fcnn", "wnd")):
        assert stats_close(jm, tm) > 0


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_matches_jax(cell, bidirectional) -> None:
    """Two recurrent layers over (B, 5, 3), one or two directions, and a
    (B, d) input as one step: F32."""
    kw = dict(cell_type=cell, hidden_dim=6, num_layers=2, bidirectional=bidirectional)
    jm, tm = build_pair(lambda r: JN.RNN(3, 2, rngs=r, **kw), lambda: TN.RNN(3, 2, **kw))
    got, ref = run_both(jm, tm, rand(8, 4, 5, 3))
    close(got, ref, what=cell)
    got, ref = run_both(jm, tm, rand(9, 4, 3))
    close(got, ref, what=f"{cell} one step")


def test_ndt_from_sklearn_tree_matches_jax() -> None:
    """`from_sklearn_tree` on a fitted depth-3 tree: the same weights (exact)
    and outputs (F32)."""
    from sklearn.tree import DecisionTreeClassifier

    rs = np.random.RandomState(0)
    x = rs.randn(80, 4).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 2] > 0).astype(int) + (x[:, 1] > 1).astype(int)
    tree = DecisionTreeClassifier(max_depth=3, random_state=0).fit(x, y)
    jm = JN.NDT.from_sklearn_tree(tree, 4, 3, rngs=nnx.Rngs(0))
    tm = TN.NDT.from_sklearn_tree(tree, 4, 3, device="cpu")
    for name in ("to_planes", "to_routes", "to_leaves"):
        assert np.array_equal(getattr(tm, name).weight.detach().numpy().T, np.asarray(getattr(jm, name).kernel[...]))
    pair(jm, tm.__class__(4, 3, num_internals=tm.to_planes.weight.shape[0], num_leaves=tm.to_routes.weight.shape[0]))
    got, ref = run_both(jm, tm, x[:10])
    close(got, ref, what="ndt")


def test_ddr_and_its_loss_match_jax() -> None:
    """DDR's median, quantiles and features, its CDF head, and the "ddr"
    loss with its items: F32."""
    jm, tm = build_pair(lambda r: JDdr.DDR(3, 1, [8, 8], num_anchors=6, rngs=r), lambda: TDdr.DDR(3, 1, [8, 8], num_anchors=6))
    x, y = rand(30, 10, 3), rand(31, 10, 1)
    got, ref = run_both(jm, tm, x)
    close(got, ref, what="ddr")
    close(tm.cdf(torch.from_numpy(x), torch.from_numpy(y)), jm.cdf(jnp.asarray(x), jnp.asarray(y)), what="cdf")
    tloss = TDdr.DDRLoss(lb_monotonous=0.5).run(got, {"labels": torch.from_numpy(y)})
    jloss = JDdr.DDRLoss(lb_monotonous=0.5).run(ref, {"labels": jnp.asarray(y)})
    assert set(tloss) == set(jloss)
    for k in jloss:
        assert abs(tloss[k].item() - float(jloss[k])) <= F32 * max(1.0, abs(float(jloss[k]))), k
    assert float(jloss["mono"]) == 0.0 == tloss["mono"].item()


def test_module_registry_covers_the_tabular_modules() -> None:
    from cflearn_torch.modules.common import module_registry
    from cflearn_tpu.modules.common import module_registry as jregistry

    names = {"linear", "fcnn", "wnd", "rnn", "fnet", "mixer", "transformer", "pool_former", "dndf", "nbm", "ndt", "ddr"}
    assert names <= set(module_registry) and names <= set(jregistry)
    assert {k for k in jregistry if k.startswith("mapping.")} == {k for k in module_registry if k.startswith("mapping.")}
    assert TN.Transformer is TN.TabTransformer
