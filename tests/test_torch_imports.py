"""The port stands alone: no JAX, flax or cppf_tpu import, and no silent
CPU fallback at its entry points."""
import ast
import glob
import os

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the card has neither cv2 nor PIL, nor orbax, tensorstore or zstandard: a
# port that reached for them would pass every CPU test and fail only on the
# card (train/orbax.py reads the checkpoints with its own zstd decoder)
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "cppf_tpu", "cv2", "PIL", "tensorstore",
             "zstandard")
PORT_FILES = sorted(glob.glob(os.path.join(ROOT, "cppf_tpu_torch", "**", "*.py"),
                              recursive=True)) + [os.path.join(ROOT, "chip_smoke.py"),
                                                  os.path.join(ROOT, "scripts",
                                                               "parallel_smoke.py"),
                                                  os.path.join(ROOT, "scripts",
                                                               "laptop_smoke.py"),
                                                  os.path.join(ROOT, "scripts",
                                                               "zero_shot_train_smoke.py"),
                                                  os.path.join(ROOT, "scripts",
                                                               "flags_smoke.py"),
                                                  os.path.join(ROOT, "scripts",
                                                               "gauges_smoke.py"),
                                                  os.path.join(ROOT, "scripts",
                                                               "reference_pth_smoke.py"),
                                                  os.path.join(ROOT, "scripts",
                                                               "orbax_smoke.py"),
                                                  os.path.join(ROOT, "scripts",
                                                               "bench_cell_smoke.py")]


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_nothing_of_jax(path):
    assert os.path.exists(path)
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_file_list_is_complete():
    names = {os.path.relpath(p, ROOT) for p in PORT_FILES}
    assert "scripts/parallel_smoke.py" in names
    assert "cppf_tpu_torch/ops/vote_hist.py" in names
    assert "cppf_tpu_torch/eval/nocs_inference.py" in names
    for module in ("eval/zero_shot.py", "eval/anchor.py", "ops/ransac.py", "data/png.py",
                   "eval/nocs_eval.py", "eval/metrics.py", "eval/box3d.py", "eval/iou3d.py",
                   "eval/sunrgbd_inference.py", "eval/sunrgbd_eval.py", "eval/alignment.py",
                   "train/step.py", "train/loop.py", "train/losses.py", "train/checkpoints.py",
                   "train/decode_val.py", "data/shapenet.py", "data/compose.py",
                   "data/synthetic.py", "data/native.py", "data/mesh.py", "core/binning.py",
                   "utils/meters.py", "parallel/mesh.py", "parallel/pose.py",
                   "parallel/input_pipeline.py", "parallel/train_step.py",
                   "parallel/launch.py", "data/resize.py", "data/exr.py",
                   "data/laptop_aux.py", "models/segmenter.py", "train/laptop_aux.py",
                   "eval/contrast_val.py", "eval/viz.py", "train/multirun.py", "data/stats.py",
                   "data/sunrgbd_synth.py", "ops/peaks.py", "utils/prof.py", "entry.py"):
        assert f"cppf_tpu_torch/{module}" in names
    assert "scripts/zero_shot_train_smoke.py" in names
    assert "scripts/flags_smoke.py" in names
    assert "scripts/gauges_smoke.py" in names
    assert "scripts/reference_pth_smoke.py" in names
    assert "scripts/orbax_smoke.py" in names
    assert "scripts/bench_cell_smoke.py" in names
    assert "cppf_tpu_torch/train/orbax.py" in names
    assert "cppf_tpu_torch/models/convert.py" in names
    for module in ("scripts/__init__.py", "scripts/synthetic_benchmark.py",
                   "scripts/sunrgbd_synthetic_benchmark.py", "scripts/zero_shot_benchmark.py",
                   "scripts/bench_zero_shot.py", "scripts/eval_checkpoints.py",
                   "scripts/probe_sun_oracle.py", "scripts/update_family_stats.py",
                   "scripts/promote.py", "scripts/bench_cell.py", "demo/__init__.py",
                   "demo/pose_single.py"):
        assert f"cppf_tpu_torch/{module}" in names


def test_port_has_every_module_of_the_jax_package():
    """Each module of cppf_tpu/ has its counterpart at the same path in the
    port, but the Pallas kernels (ported as csrc/*.cu) and utils/cache.py
    (JAX's compilation cache; the port caches its kernel builds in
    _build/)."""
    jax_root, port_root = os.path.join(ROOT, "cppf_tpu"), os.path.join(ROOT, "cppf_tpu_torch")
    modules = {os.path.relpath(p, jax_root)
               for p in glob.glob(os.path.join(jax_root, "**", "*.py"), recursive=True)}
    unported = {m for m in modules
                if m.startswith("ops/pallas/") or m == "utils/cache.py"}
    assert unported == {"ops/pallas/__init__.py", "ops/pallas/vote_hist.py", "utils/cache.py"}
    missing = sorted(m for m in modules - unported
                     if not os.path.exists(os.path.join(port_root, m)))
    assert not missing, f"no counterpart in cppf_tpu_torch/ of {missing}"


# public top-level names of cppf_tpu/ that the port has no function or
# class of the same name for, and why
UNMATCHED = {
    "enable_compilation_cache": "JAX's compilation cache (utils/cache.py); the port caches "
                                "its kernel builds in _build/",
    "named_sharding": "a JAX NamedSharding; the port shards by rank over torch.distributed",
    "shard_batch_spec": "JAX PartitionSpecs of a batch; parallel/train_step.py slices the "
                        "batch by rank",
    "have_native": "JAX's numpy fallback for when g++ is missing; the port builds "
                   "native/rasterizer.cpp and has no fallback",
    "voxel_downsample_np": "ops/quantize.py::voxel_downsample_host",
    "laptop_up_from_aux": "split into eval/nocs_inference.py::laptop_crop and "
                          "laptop_up_from_labels",
    "make_models": "models/convert.py::make_encoders (torch modules of the same widths)",
    "time_fn": "utils/prof.py's spans time each stage of a pose on the card's own clock, "
               "with no synchronize between stages; nothing read the port's copy",
    "component_times": "as time_fn",
}


def _top_level_names(root):
    names = {}
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        for node in ast.parse(open(path).read(), path).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                names.setdefault(node.name, []).append(os.path.relpath(path, root))
    return names


def test_port_has_every_function_of_the_jax_package():
    """Each public top-level function and class of cppf_tpu/ has a
    same-named counterpart somewhere in cppf_tpu_torch/, but the listed
    few, each for its reason; none of those has since gained one."""
    jax_names = _top_level_names(os.path.join(ROOT, "cppf_tpu"))
    port_names = _top_level_names(os.path.join(ROOT, "cppf_tpu_torch"))
    missing = {n: jax_names[n] for n in sorted(set(jax_names) - set(port_names) - set(UNMATCHED))}
    assert not missing, f"no counterpart in cppf_tpu_torch/ of {missing}"
    assert set(UNMATCHED) <= set(jax_names)
    assert not set(UNMATCHED) & set(port_names)


def test_runner_needs_cuda_unless_told_cpu():
    from cppf_tpu_torch.eval.nocs_inference import CategoryRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CategoryRunner("bowl")
    runner = CategoryRunner("bowl", device="cpu")
    assert runner.device.type == "cpu"
    assert runner.pcfg.grid_shape == (64, 64, 64)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
