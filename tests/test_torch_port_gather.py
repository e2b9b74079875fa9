"""The gather microbenchmark's plain versions (datr_torch/ops/gather.py)
against the Pallas kernels they replace, run in interpret mode on the CPU
(tools/msda_pallas_bench.py:run_copy, run_fma), and against the functions
the tools document. The interpret-mode runs take about a minute, so they sit
in this file of their own."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from datr_torch.ops import gather
from datr_torch.tools import msda_gather_bench as bench
from tools import msda_pallas_bench as jbench

# one bf16 ulp: the f32 sums of two orders may round to neighbouring bf16s
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def inputs():
    table, idx, w = bench.bench_inputs("cpu")
    return table, idx, w


def test_bench_shapes_are_the_tpu_bench_shapes(inputs):
    table, idx, w = inputs
    assert table.shape == (jbench.T, 128) and table.dtype == torch.bfloat16
    assert idx.shape == (jbench.NBLK * jbench.NGRID,)
    assert w.shape == (jbench.NBLK * jbench.NGRID, 1)


def test_row_gather_plain_matches_run_copy_first_block(inputs):
    """run_copy in interpret mode equals the port on the first grid block,
    exactly. Beyond it the TPU kernel re-gathers the first block's indices
    on every grid step (copy_kernel reads idx_ref[i], not the step's
    offset); the port computes the documented table[idx] everywhere."""
    table, idx, _ = inputs
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jbench.run_copy(
            jnp.asarray(table.float().numpy(), jnp.bfloat16),
            jnp.asarray(idx.numpy())).astype(jnp.float32))
    got = gather.row_gather(table, idx).float().numpy()
    nb = jbench.NBLK
    np.testing.assert_array_equal(got[:nb], out[:nb])
    np.testing.assert_array_equal(out, np.tile(out[:nb], (jbench.NGRID, 1)))
    np.testing.assert_array_equal(got, table.float().numpy()[idx.numpy()])


def test_gather_fma_plain_matches_run_fma_first_block(inputs):
    """run_fma in interpret mode against the port on the first grid block
    (128 outputs), to one bf16 ulp; the port's plain version against the
    f32 numpy sum over all 2,048 outputs, to one bf16 rounding."""
    table, idx, w = inputs
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jbench.run_fma(
            jnp.asarray(table.float().numpy(), jnp.bfloat16),
            jnp.asarray(idx.numpy()), jnp.asarray(w.numpy())
        ).astype(jnp.float32))
    got = gather.gather_fma(table, idx, w).float().numpy()
    nq = jbench.NBLK // bench.K
    np.testing.assert_allclose(got[:nq], out[:nq], rtol=BF16_ULP, atol=1e-5)
    want = (table.float().numpy()[idx.numpy()] * w.numpy()).reshape(
        -1, bench.K, 128).sum(1)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-5)


@pytest.mark.parametrize("name", sorted(bench.PROBES))
def test_probe_patterns_against_numpy(name):
    """The mosaic probes only report whether Mosaic lowers them; the port
    computes what they gather, table[idx + offset], exactly."""
    table, idx, offset = bench.probe_inputs(name, "cpu")
    want = table.numpy()[idx.numpy() + offset]
    np.testing.assert_array_equal(
        gather.row_gather(table, idx, offset).numpy(), want)


def test_cpu_dispatch_counts_no_launch(inputs):
    table, idx, w = inputs
    before = (gather.row_gather.launches, gather.gather_fma.launches)
    gather.row_gather(table, idx)
    gather.gather_fma(table, idx, w)
    assert (gather.row_gather.launches, gather.gather_fma.launches) == before


def test_gather_fma_takes_only_bf16(inputs):
    """gather_fma is the bf16 bench's kernel: an f32 table raises on every
    device, so the CPU and the card compute the same function."""
    table, idx, w = inputs
    with pytest.raises(ValueError, match="bf16"):
        gather.gather_fma(table.float(), idx, w)


def test_other_devices_raise(inputs):
    table, idx, w = (x.to("meta") for x in inputs)
    with pytest.raises(ValueError, match="unsupported device"):
        gather.row_gather(table, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        gather.gather_fma(table, idx, w)


def test_bench_entry_point_on_cpu(capsys):
    """`python -m datr_torch.tools.msda_gather_bench --device cpu`: every
    case checks out, one JSON line each."""
    assert bench.main(["--device", "cpu", "--iters", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["case"] for r in lines] == ["copy", "fma", *bench.PROBES]
    assert all(r["ok"] and r["device"] == "cpu" for r in lines)
