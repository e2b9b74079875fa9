"""The port's tools on the CPU: train_bench and profile_model with
`--device cpu --tiny` each print one JSON line (host-clock numbers, not
device metrics), profile_model's `summarize` reads a saved trace and sorts
the card's kernel names into their categories, stage_data copies
incrementally and unzips as datr_tpu's tools/stage_data.py does, and
`repro_c2f --dry_run --device cpu` drives every stage in a process of its
own that loads neither jax nor datr_tpu."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import zipfile

import pytest
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.tools import profile_model, stage_data, train_bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_tools_stage_data", os.path.join(ROOT, "tools", "stage_data.py"))
jstage = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jstage)


def _json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.strip().splitlines()]


def test_train_bench_prints_one_json_line(capsys):
    res = train_bench.main(["--device", "cpu", "--tiny", "--steps", "1"])
    (line,) = _json_lines(capsys.readouterr().out)
    assert line == res
    assert line["metric"] == "burnin_s_per_step" and line["unit"] == "s/step"
    assert line["value"] > 0 and line["clock"] == "host"
    assert line["msda_fwd_launches"] == line["msda_bwd_launches"] == 0


def test_profile_model_and_summarize(tmp_path, capsys):
    res = profile_model.main(["--device", "cpu", "--tiny", "--copies",
                              "--trace-dir", str(tmp_path)])
    (line,) = _json_lines(capsys.readouterr().out)
    assert line["profile"] == "eval_forward" and line["clock"] == "host"
    assert 0 < line["busy_share"] <= 1 and line["kernels"] > 0
    assert line["copies"]["calls"] >= line["copies"]["casts"] > 0
    again = profile_model.main(["--summarize-only", str(tmp_path)])
    capsys.readouterr()
    assert again["categories_ms"] == res["categories_ms"]
    assert again["busy_ms"] == res["busy_ms"]


@pytest.mark.parametrize("name,cat", [
    ("void msda_fwd_kernel<float, float, 4, 3>(float const*, ...)",
     "msda_fwd"),
    ("void msda_bwd_run_kernel<__nv_bfloat16>(...)", "msda_bwd"),
    ("msda_round_bf16_kernel(float const*, ...)", "msda_bwd"),
    ("void at::native::elementwise_kernel<128, 4, at::native::"
     "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(...)",
     "copy/cast"),
    ("Memset (Device)", "memset"),
    ("Memcpy HtoD (Pageable -> Device)", "copy/cast"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc", "conv"),
    ("void fft2d_r2c_32x32<float, false, 0u, false>(...)", "conv_fft"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "gemm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "gemm"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<...>",
     "reduce"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<float, float, false>(...)", "reduce"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>",
     "sort/top-k"),
    ("void at::native::index_elementwise_kernel<128, 4, ...>", "index"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, ...>", "elementwise"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_categories(name, cat):
    assert profile_model.category(name) == cat


def _tree(root):
    for rel, data in (("a.txt", b"one"), ("d/b.bin", b"\x00" * 9),
                      ("d/e/c.json", b"{}")):
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)


def test_stage_data_as_datr_tpus(tmp_path, capsys):
    """The port's copy against datr_tpu's: the same counts and JSON keys,
    a second staging copies nothing, --overwrite copies again, and a zip
    is extracted."""
    src = tmp_path / "src"
    _tree(src)
    for mod, dst in ((stage_data, tmp_path / "p"), (jstage, tmp_path / "j")):
        assert mod.stage_tree(str(src), str(dst)) == (3, 0)
        assert mod.stage_tree(str(src), str(dst)) == (0, 3)
        assert mod.stage_tree(str(src), str(dst), overwrite=True) == (3, 0)
    assert sorted(p.relative_to(tmp_path / "p") for p in
                  (tmp_path / "p").rglob("*")) == sorted(
        p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*"))
    assert (tmp_path / "p" / "d" / "b.bin").read_bytes() == b"\x00" * 9
    zpath = tmp_path / "t.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.writestr("x/y.txt", "zz")
        z.writestr("w.txt", "ww")
    stage_data.main([str(zpath), str(tmp_path / "z")])
    line = json.loads(capsys.readouterr().out)
    jstage.main([str(zpath), str(tmp_path / "jz")])
    jline = json.loads(capsys.readouterr().out)
    assert line["mode"] == jline["mode"] == "unzip"
    assert line["files"] == jline["files"] == 2
    assert sorted(line) == sorted(jline)
    assert (tmp_path / "z" / "x" / "y.txt").read_text() == "zz"


_RUN = """
import json, runpy, sys
sys.argv = ["repro_c2f"] + sys.argv[1:]
runpy.run_module("datr_torch.tools.repro_c2f", run_name="__main__")
print(json.dumps({"loaded": sorted(m for m in sys.modules if m.split(".")[0]
                  in ("jax", "jaxlib", "flax", "optax", "datr_tpu"))}))
"""


def test_repro_dry_run_without_jax(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS=str(
        torch_port_threads.THREADS or os.cpu_count()))
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, "--dry_run", "--device", "cpu",
         "--work_dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    stages = {ln["stage"]: ln for ln in lines if "stage" in ln}
    assert all(stages[s]["ok"] for s in ("stage", "convert", "eval"))
    (verdict,) = [ln for ln in lines if ln.get("repro") == "c2f"]
    assert verdict["dry_run"] and verdict["expect"] == 52.8
    assert isinstance(verdict["map50"], float)
    assert lines[-1] == {"loaded": []}
    assert (tmp_path / "converted.pth").exists()
    shutil.rmtree(tmp_path)  # two R50 .pth files: the suite shares one disk
