"""Port parity: the plain versions of kernels B1-B3 against the JAX Pallas kernels run in
interpret mode (CPU, f32), and the wrappers' CPU dispatch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from freqfusion_tpu.models.nafnet import NAFBlock as JNAFBlock
from freqfusion_tpu.ops.pallas.cab import conv3x3_dense as jconv3x3_dense
from freqfusion_tpu.ops.pallas.nafblock import fused_naf_block as jfused_naf_block
from freqfusion_tpu_torch.ops.kernels import conv3x3, nafblock

torch.set_num_threads(2)


def _jax_block_params(c, seed):
    """JAX NAFBlock params with every leaf (β/γ included) random and non-zero: at
    init β = γ = 0 and the block is the identity."""
    rng = np.random.default_rng(seed)
    variables = JNAFBlock(c).init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, c)))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])


def _port_params(p, c):
    """JAX param tree -> the port's fused-kernel layouts (torch tensors)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    mat = lambda k: t(np.asarray(k).reshape(k.shape[-2], k.shape[-1]))
    return dict(
        ln1_w=t(p["norm1"]["weight"]), ln1_b=t(p["norm1"]["bias"]),
        w1=mat(p["conv1"]["kernel"]), b1=t(p["conv1"]["bias"]),
        wdw=t(np.asarray(p["conv2"]["kernel"]).reshape(9, 2 * c)),
        bdw=t(p["conv2"]["bias"]),
        sca_w=mat(p["sca"]["kernel"]), sca_b=t(p["sca"]["bias"]),
        w3=mat(p["conv3"]["kernel"]), b3=t(p["conv3"]["bias"]), beta=t(p["beta"]),
        ln2_w=t(p["norm2"]["weight"]), ln2_b=t(p["norm2"]["bias"]),
        w4=mat(p["conv4"]["kernel"]), b4=t(p["conv4"]["bias"]),
        w5=mat(p["conv5"]["kernel"]), b5=t(p["conv5"]["bias"]), gamma=t(p["gamma"]))


@pytest.mark.parametrize("c,h,w,b,seed", [(16, 24, 32, 2, 0), (8, 6, 16, 1, 3)])
def test_fused_naf_block_matches_jax_kernel(c, h, w, b, seed):
    p = _jax_block_params(c, seed)
    x = (0.5 * np.random.default_rng(seed + 10).standard_normal((b, h, w, c))
         ).astype(np.float32)
    jp = dict(ln1_w=p["norm1"]["weight"], ln1_b=p["norm1"]["bias"],
              w1=p["conv1"]["kernel"], b1=p["conv1"]["bias"],
              wdw=p["conv2"]["kernel"], bdw=p["conv2"]["bias"],
              w3=p["conv3"]["kernel"], b3=p["conv3"]["bias"], beta=p["beta"],
              ln2_w=p["norm2"]["weight"], ln2_b=p["norm2"]["bias"],
              w4=p["conv4"]["kernel"], b4=p["conv4"]["bias"],
              w5=p["conv5"]["kernel"], b5=p["conv5"]["bias"], gamma=p["gamma"])
    want = jfused_naf_block(jnp.asarray(x), jp, p["sca"]["kernel"], p["sca"]["bias"],
                            interpret=True)
    tp = _port_params(p, c)
    got = nafblock.fused_naf_block_plain(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)
    # the wrapper on a CPU tensor is its plain version, and launches nothing
    before = dict(nafblock.launches)
    np.testing.assert_array_equal(
        nafblock.fused_naf_block(torch.from_numpy(x), tp).numpy(), got.numpy())
    assert nafblock.launches == before


def test_stage_a_sums_are_the_sums_of_g():
    p = _port_params(_jax_block_params(8, 5), 8)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 5, 7, 8))
                         .astype(np.float32))
    g, sums = nafblock.naf_block_stage_a(x, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"],
                                         p["wdw"], p["bdw"])
    assert g.shape == x.shape and sums.shape == (2, 8)
    np.testing.assert_allclose(sums.numpy(), g.numpy().sum(axis=(1, 2)), atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 3)])
def test_conv3x3_dense_matches_jax_kernel(cin, cout):
    rng = np.random.default_rng(cin * 100 + cout)
    x = rng.standard_normal((2, 12, 20, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    want = jconv3x3_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    got = conv3x3.conv3x3_dense_plain(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    before = dict(conv3x3.launches)
    np.testing.assert_array_equal(conv3x3.conv3x3_dense(*args).numpy(), got.numpy())
    assert conv3x3.launches == before


def test_kernel_modules_need_neither_nvcc_nor_a_gpu(monkeypatch):
    """Importing the kernel modules and calling the wrappers on CPU tensors never builds
    or loads the CUDA library; asking for the build without nvcc raises a clear error."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from freqfusion_tpu_torch.ops.kernels import _build, conv3x3, nafblock\n"
        "conv3x3.conv3x3_dense(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 4),"
        " torch.zeros(4))\n"
        "assert _build._LIBRARY is None\n"
        "assert not _build.BUILD_DIR.exists() or not any(_build.BUILD_DIR.glob('*.tmp'))\n")
    env = {"PATH": "", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(__import__("pathlib").Path(__file__).parents[1])}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)

    from freqfusion_tpu_torch.ops.kernels import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
