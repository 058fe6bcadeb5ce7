"""cor_tpu_torch's opt-in decode schedules against cor_tpu's, on the CPU.

cor_tpu's fused two-way transformer has three schedules beside its
per-layer kernel (K1), each behind a module flag of models/sam_decoder.py:
the layer with double-buffered keys (``DMA_FUSED``, K1-dma), the whole
depth-2 transformer in one kernel with the token state fp32 throughout
(``STACK_FUSED``, K1-stack) or rounded between the layers (``GRID_FUSED``,
K1-grid). The same inputs, made with numpy from a seed, and the same weights
(a cor_tpu tree carried over by the weight bridge) go through cor_tpu's
Pallas kernels in interpret mode, as its own tests run them, and the port's
wrappers, which take their plain versions on the CPU. SAM's decoder geometry
(C 256, 8 heads, MLP 2048) on N = 1,024 rows (32 x 32, one of cor_tpu's row
tiles), at 5 and 8 tokens. Tolerances: cor_tpu's own
(tests/test_two_way_layer_kernel.py), 2e-4 for a layer and 5e-4 for the
transformer, in fp32; in bf16 BF16_REL, max |port - cor_tpu| / max
|cor_tpu| (about two bf16 ulps at the outputs' largest value).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cor_tpu.models.sam_decoder as jsd
import cor_tpu.ops.pallas.two_way_layer as jtwl
from cor_tpu.retrieval import engine as jengine
from cor_tpu_torch.models import sam_decoder as psd
from cor_tpu_torch.ops.kernels import two_way_layer as ptwl
from cor_tpu_torch.ops.kernels import two_way_stack as ptws
from cor_tpu_torch.tools import decode_bench
from cor_tpu_torch.utils.weights import load_cor_tpu_params

LTOL = dict(atol=2e-4, rtol=2e-4)  # a layer
TTOL = dict(atol=5e-4, rtol=5e-4)  # the transformer
BF16_REL = 2e-2
N, C = 1024, 256


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def sam():
    """A full-width SAM two-way transformer in both packages, and cor_tpu's
    three schedules as jitted graphs (shared by the tests of this module)."""
    cfg = jsd.TwoWayTransformerConfig()
    p = jax.tree.map(np.asarray, jsd.init_two_way_transformer(jax.random.PRNGKey(0), cfg))
    port = load_cor_tpu_params(psd.TwoWayTransformer(psd.TwoWayTransformerConfig()), p)
    graphs = {
        "dma": jax.jit(jtwl.two_way_layer_dma, static_argnames=("num_heads", "skip_pe")),
        "stack": jax.jit(jtwl.two_way_stack_fused, static_argnames=("num_heads",)),
        "grid": jax.jit(jtwl.two_way_grid_fused, static_argnames=("num_heads",)),
    }
    return p, port, graphs


def int8_store(store: np.ndarray):
    q, scale = jengine.quantize_candidate_store(store)
    return np.asarray(q), np.asarray(scale)


@pytest.mark.parametrize("case", ["rows", "store", "int8"])
@pytest.mark.parametrize("T", [5, 8])
def test_two_way_layer_dma_matches_pallas(sam, rng, T, case):
    """K1-dma at B = 3 (cor_tpu groups G = 1 candidate a step: three grid
    steps, so its slot-reuse waits run): the second layer on rows; the first
    on a store through a permuted index, and on an int8 store with its
    scales."""
    p, port, graphs = sam
    B = 3
    layer = 1 if case == "rows" else 0
    tok = rng.standard_normal((B, T, C)).astype(np.float32) * 0.5
    kpe, qpe = (rng.standard_normal((N, 128)).astype(np.float32) * 0.3 for _ in range(2))
    rows = rng.standard_normal((B if case == "rows" else 5, N, C)).astype(np.float32) * 0.3
    idx = scale = None
    if case != "rows":
        idx = np.array([4, 0, 2], np.int32)
    if case == "int8":
        rows, scale = int8_store(rows.reshape(5, 32, 32, C))
        rows = rows.reshape(5, N, C)
    want = graphs["dma"](p["layers"][layer], tok, tok, rows, kpe, qpe, num_heads=8,
                         skip_pe=layer == 0, keys_idx=idx, keys_scale=scale)
    before = ptwl.two_way_layer_dma.launches + ptwl.two_way_layer_dma.launches_fp32
    got = ptwl.two_way_layer_dma(
        port.layers[layer], t(tok), t(tok), t(rows), t(kpe), t(qpe), layer == 0,
        idx=None if idx is None else t(idx), scale=None if scale is None else t(scale))
    assert ptwl.two_way_layer_dma.launches + ptwl.two_way_layer_dma.launches_fp32 == before
    assert got[0].shape == (B, T, C) and got[1].shape == (B, N, C)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LTOL)


def transformer_inputs(rng, B, T, S=None):
    tok = rng.standard_normal((B, T, C)).astype(np.float32) * 0.5
    rows = rng.standard_normal((S or B, N, C)).astype(np.float32) * 0.3
    pes = [rng.standard_normal((N, 128)).astype(np.float32) * 0.3 for _ in range(5)]
    return tok, rows, pes


@pytest.mark.parametrize("indexed", [False, True], ids=["rows", "store"])
@pytest.mark.parametrize("T", [5, 8])
@pytest.mark.parametrize("kind", ["stack", "grid"])
def test_two_way_stack_and_grid_match_pallas(sam, rng, kind, T, indexed):
    """K1-stack and K1-grid at B = 4 (cor_tpu: one step of G = 4), on rows
    and on a store through a permuted index."""
    p, port, graphs = sam
    tok, rows, pes = transformer_inputs(rng, 4, T, S=6 if indexed else None)
    idx = np.array([5, 1, 3, 0], np.int32) if indexed else None
    want = graphs[kind](p, tok, tok, rows, pes[:2], pes[2:4], pes[4], num_heads=8, keys_idx=idx)
    fn = ptws.two_way_grid_fused if kind == "grid" else ptws.two_way_stack_fused
    before = fn.launches + fn.launches_fp32
    got = fn(port, t(tok), t(tok), t(rows), [t(x) for x in pes[:2]], [t(x) for x in pes[2:4]],
             t(pes[4]), idx=None if idx is None else t(idx))
    assert fn.launches + fn.launches_fp32 == before  # the CPU takes the plain version
    assert got[0].shape == (4, T, C) and got[1].shape == (4, N, C)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TTOL)


@pytest.mark.parametrize("T", [5, 8])
def test_stack_and_grid_bf16_hold_their_rounding_points(sam, rng, T):
    """In bf16 K1-stack keeps the token state fp32 between the layers and
    K1-grid rounds it: each plain version is within BF16_REL of cor_tpu's
    kernel of its schedule, and its tokens are closer to that kernel's than
    to the other schedule's (mean |d| at most 0.6 of the other; measured
    ~0.33)."""
    p, port, graphs = sam
    tok, rows, pes = transformer_inputs(rng, 4, T)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    pj = jax.tree.map(bf, p)
    want = {k: [np.asarray(x.astype(jnp.float32)) for x in graphs[k](
        pj, bf(tok), bf(tok), bf(rows), [bf(x) for x in pes[:2]], [bf(x) for x in pes[2:4]],
        bf(pes[4]), num_heads=8)] for k in ("stack", "grid")}
    pb = copy.deepcopy(port).to(torch.bfloat16)
    tb = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    got = {}
    for k, fn in (("stack", ptws.two_way_stack_fused), ("grid", ptws.two_way_grid_fused)):
        got[k] = [x.float().numpy() for x in fn(pb, tb(tok), tb(tok), tb(rows),
                                                [tb(x) for x in pes[:2]],
                                                [tb(x) for x in pes[2:4]], tb(pes[4]))]
    for k, other in (("stack", "grid"), ("grid", "stack")):
        for g, w in zip(got[k], want[k]):
            assert np.abs(g - w).max() / np.abs(w).max() <= BF16_REL, k
        own = np.abs(got[k][0] - want[k][0]).mean()
        cross = np.abs(got[k][0] - want[other][0]).mean()
        assert own <= 0.6 * cross, (k, own, cross)


ROUTES = {  # flags set -> the route both packages take
    ("DMA_FUSED",): "dma", ("STACK_FUSED",): "stack", ("GRID_FUSED",): "grid",
    ("GRID_FUSED", "STACK_FUSED"): "grid", ("DMA_FUSED", "STACK_FUSED"): "stack",
    ("GRID_FUSED", "int8"): "layer", ("GRID_FUSED", "STACK_FUSED", "DMA_FUSED", "int8"): "dma",
}


def spy(monkeypatch, module, names, calls):
    for name, route in names.items():
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _fn=fn, _r=route, **k: calls.append(_r) or _fn(*a, **k))


@pytest.mark.parametrize("flags", list(ROUTES), ids=["+".join(f) for f in ROUTES])
def test_two_way_transformer_with_flags_matches(sam, rng, monkeypatch, flags):
    """The port's ``two_way_transformer`` with cor_tpu's flags set in both
    packages: the same route (GRID_FUSED before STACK_FUSED; an int8 store
    sends both to the per-layer kernels, K1 or K1-dma), the same outputs."""
    p, port, _ = sam
    for f in ("DMA_FUSED", "STACK_FUSED", "GRID_FUSED"):
        monkeypatch.setattr(jsd, f, f in flags)
        monkeypatch.setattr(psd, f, f in flags)
    names = {"two_way_layer_fused": "layer", "two_way_layer_dma": "dma",
             "two_way_stack_fused": "stack", "two_way_grid_fused": "grid"}
    jcalls, pcalls = [], []
    spy(monkeypatch, jtwl, names, jcalls)
    spy(monkeypatch, psd, {"two_way_layer": "layer", "two_way_layer_dma": "dma",
                           "two_way_stack_fused": "stack", "two_way_grid_fused": "grid"}, pcalls)
    pe = rng.standard_normal((1, 32, 32, C)).astype(np.float32) * 0.3
    tok = rng.standard_normal((2, 6, C)).astype(np.float32) * 0.5
    if "int8" in flags:
        q, scale = int8_store(rng.standard_normal((3, 32, 32, C)).astype(np.float32) * 0.3)
        idx = np.array([2, 0], np.int32)
        want = jsd.two_way_transformer(p, q, pe, tok, jsd.TwoWayTransformerConfig(), fused=True,
                                       store_idx=jnp.asarray(idx),
                                       store_scale=jnp.asarray(scale))
        got = psd.two_way_transformer(port, t(q), t(pe), t(tok), store_idx=t(idx),
                                      store_scale=t(scale))
    else:
        img = rng.standard_normal((2, 32, 32, C)).astype(np.float32) * 0.3
        want = jsd.two_way_transformer(p, img, pe, tok, jsd.TwoWayTransformerConfig(),
                                       fused=True)
        got = psd.two_way_transformer(port, t(img), t(pe), t(tok))
    route = ROUTES[flags]
    assert set(jcalls) == set(pcalls) == {route}, (jcalls, pcalls)
    assert len(pcalls) == (2 if route in ("layer", "dma") else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TTOL)


@pytest.mark.parametrize("variant,int8", [("layer", False), ("dma", True), ("stack", False),
                                          ("grid", False)])
def test_decode_bench_runs_on_the_cpu(variant, int8):
    """decode_bench's run at a small chunk on the CPU: the kernels' plain
    versions, the host's clock, the device named; no launch counted."""
    out = decode_bench.run(variant, int8, store=3, chunks=1, iters=1, chunk=2, device="cpu")
    assert out["variant"] == variant and out["int8"] == int8
    assert out["device"] == "cpu" and out["timer"] == "host clock" and out["card"] is None
    assert out["ms_per_chunk"] > 0 and out["launches_per_chunk"] == {}


def test_decode_bench_refuses_what_has_no_cuda_counterpart(capsys):
    for argv in (["--semantics", "parallel"], ["--cost"], ["--variant", "grid", "--int8"],
                 ["--variant", "stack", "--int8"]):
        with pytest.raises(SystemExit):
            decode_bench.main(argv + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert "no CUDA counterpart" in err and "per-layer kernel (K1)" in err
    with pytest.raises(ValueError, match="no int8 store"):
        decode_bench.run("stack", True, device="cpu")
