"""cor_tpu_torch's kernel modules against cor_tpu's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held here against cor_tpu's kernels run the way cor_tpu's own tests run them
on the CPU (Pallas interpret mode, or cor_tpu's XLA fallback), at cor_tpu's
kernel-test tolerance (tests/test_pallas_kernels.py, test_kernel_vjp.py):
atol = rtol = 1e-5 in fp32.

The tests marked ``gpu`` hold each CUDA kernel against its plain version in
bf16 at the serving path's shapes; they skip without a CUDA card. A machine
with a card but without jax runs them with

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

which is why this file imports jax and cor_tpu only inside the CPU tests.
"""

import numpy as np
import pytest
import torch

from cor_tpu_torch.ops.kernels.layernorm import layer_norm, layer_norm_plain
from cor_tpu_torch.ops.kernels.seq_attention import attention_seq_qkv, attention_seq_qkv_plain

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape", [(2, 64, 128), (3, 5, 64)], ids=["pallas-interpret", "xla-fallback"]
)
def test_layer_norm_plain_matches_pallas(rng, shape):
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.layernorm import layer_norm_pallas

    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    s = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=1e-6))
    t = [torch.from_numpy(a) for a in (x, s, b)]
    np.testing.assert_allclose(layer_norm_plain(*t, 1e-6).numpy(), want, **TOL)
    # on a CPU tensor the wrapper is the plain version, and counts no launch
    before = layer_norm.launches
    np.testing.assert_allclose(layer_norm(*t, 1e-6).numpy(), want, **TOL)
    assert layer_norm.launches == before


@pytest.mark.parametrize("width,n", [(128, 36), (128, 64), (64, 36), (64, 64)],
                         ids=["d64-n36", "d64-n64", "d32-n36", "d32-n64"])
def test_attention_seq_qkv_plain_matches_pallas(rng, width, n):
    # width 128 / 2 heads: head_dim 64, cor_tpu's _qkv_pair_call kernel;
    # width 64 / 2 heads: head_dim 32, its attention_seq_pallas kernel
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.seq_attention import attention_seq_qkv_pallas

    qkv = rng.standard_normal((2, n, 3 * width)).astype(np.float32)
    want = np.asarray(attention_seq_qkv_pallas(jnp.asarray(qkv), num_heads=2))
    t = torch.from_numpy(qkv)
    np.testing.assert_allclose(attention_seq_qkv_plain(t, 2).numpy(), want, **TOL)
    before = attention_seq_qkv.launches
    np.testing.assert_allclose(attention_seq_qkv(t, 2).numpy(), want, **TOL)
    assert attention_seq_qkv.launches == before


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        layer_norm(x, torch.empty(128, device="meta"), torch.empty(128, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        attention_seq_qkv(torch.empty(1, 4, 384, device="meta"), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [16 * 576, 16 * 64, 1001])
def test_layer_norm_kernel_matches_plain_bf16(cuda_device, rows):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (2 * torch.randn(rows, 768, generator=g, device=cuda_device) + 0.5).to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(768, generator=g, device=cuda_device)).to(torch.bfloat16)
    b = (0.1 * torch.randn(768, generator=g, device=cuda_device)).to(torch.bfloat16)
    before = layer_norm.launches
    got = layer_norm(x, s, b)
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 1
    # one bf16 ulp at |y| <= 4 is 1.6e-2; both take fp32 statistics
    torch.testing.assert_close(got.float(), layer_norm_plain(x, s, b).float(), atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [576, 64, 100])
def test_attention_seq_qkv_kernel_matches_plain_bf16(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(16, n, 3 * 768, generator=g, device=cuda_device).to(torch.bfloat16)
    before = attention_seq_qkv.launches
    got = attention_seq_qkv(qkv, 12)
    torch.cuda.synchronize()
    assert attention_seq_qkv.launches == before + 1
    # the online softmax rounds P to bf16 at other places than the plain version
    torch.testing.assert_close(
        got.float(), attention_seq_qkv_plain(qkv, 12).float(), atol=2e-2, rtol=0
    )


@pytest.mark.gpu
def test_attention_seq_qkv_kernel_refuses_other_head_dims(cuda_device):
    qkv = torch.zeros(1, 8, 3 * 1152, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64"):
        attention_seq_qkv(qkv, 16)  # SO400M: head_dim 72
