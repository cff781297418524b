"""What the port covers of the JAX package, read from the sources by AST
(nothing is imported, so the whole file runs in well under a second).

  * Every public top-level `def` or `class` of every module under
    tamgcn_tpu/ has a namesake in the port's module at the same relative
    path, or an entry in RENAMED (the port's names, `path:name` or a file,
    each found by AST or on disk) or in NO_COUNTERPART (a reason). A whole
    module may take one entry, keyed by its path.
  * Every `pl.pallas_call` site in tamgcn_tpu/ and tools/, keyed by its
    enclosing function, maps to a row of PERF.md's kernel table (K1-K6, T1,
    T2), and each row to CUDA sources in tamgcn_tpu_torch/csrc/ that exist;
    every source there belongs to a row.
  * Every tools/*.py has tamgcn_tpu_torch/tools/<name>.py, another name in
    TOOLS_RENAMED, or a reason in TOOLS_NOT_PORTED.
  * Every option of tamgcn_tpu/train/config.py (the strings given to
    `add_argument`) is an option of the port's, and every subcommand of
    main.py (the keys of its `registry`) one of tamgcn_tpu_torch/__main__.py.
  * No entry of a table is stale: its JAX name exists and has no namesake
    in the port, and its port names exist.

To extend the port: give a new JAX name its namesake at the same path, or
add it here with the port's name or a reason; a port name that is removed
fails the entry that points to it.
"""
import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "tamgcn_tpu"
PORT = REPO / "tamgcn_tpu_torch"
CSRC = PORT / "csrc"

# JAX name ("path:name", or a module "path") -> the port's names that do
# its work ("path:name" or a file, relative to tamgcn_tpu_torch/)
RENAMED = {
    "models/stgcn.py:torch_conv_default_kernel_init": ("ops/inits.py:torch_conv_default_",),
    "models/stgcn.py:torch_conv_default_bias_init": ("ops/inits.py:torch_conv_default_",),
    "ops/aggregation.py:ctr_gc_fused_xla": ("ops/aggregation.py:ctr_gc_fused_plain",),
    "ops/aggregation.py:unit_ctr_gc_xla": ("ops/aggregation.py:unit_ctr_gc_plain",),
    "ops/inits.py:kaiming_normal_fan_out": ("ops/inits.py:kaiming_normal_fan_out_",),
    "ops/inits.py:kaiming_normal_fan_out_blocked": (
        "ops/inits.py:kaiming_normal_fan_out_blocked_",),
    "ops/inits.py:kaiming_normal_fan_out_dense": ("ops/inits.py:kaiming_normal_fan_out_dense_",),
    "ops/inits.py:fc_init": ("ops/inits.py:fc_init_",),
    "ops/pallas/__init__.py": ("ops/cuda/__init__.py",),
    "ops/pallas/ctr_gc.py:ctr_gc_fused_pallas": (
        "ops/aggregation.py:CtrGcFused", "ops/cuda/ctr_gc.py:ctr_gc_fused_bf16",
        "csrc/ctr_gc_fused.cu"),
    "ops/pallas/ctr_gc.py:unit_ctr_gc_fwd_pallas": (
        "ops/cuda/ctr_gc.py:unit_ctr_gc_fwd", "csrc/unit_ctr_gc_fwd.cu"),
    "ops/pallas/ctr_gc.py:unit_ctr_gc_bwd_pallas": (
        "ops/cuda/ctr_gc.py:unit_ctr_gc_bwd_dx3", "ops/cuda/ctr_gc.py:unit_ctr_gc_bwd_param",
        "csrc/unit_ctr_gc_bwd_dx3.cu", "csrc/unit_ctr_gc_bwd_param.cu",
        "csrc/unit_ctr_gc_bwd_param_bf16.cu"),
    "ops/pallas/ctr_gc.py:unit_ctr_gc_bwd_conv3_pallas": (
        "ops/cuda/ctr_gc.py:unit_ctr_gc_bwd_conv3", "csrc/unit_ctr_gc_bwd_conv3.cu"),
    "ops/pallas/gcn_tcn_block.py:gcn_tcn_block_fused": (
        "ops/gcn_tcn_block.py:gcn_tcn_block_fused", "ops/cuda/gcn_tcn_block.py:gcn_tcn_block_fwd",
        "csrc/gcn_tcn_block.cu"),
    "parallel/sharded.py:SharedTrainState": ("train/packing.py:PackedTrainState",),
    "parallel/sharded.py:make_train_step": (
        "parallel/drive.py:train_on_grid", "parallel/sharded.py:GradientSum"),
    "parallel/sharded.py:make_packed_train_step": (
        "train/packing.py:make_fused_train_step", "parallel/sharded.py:GradientSum"),
    "parallel/sharded.py:init_sharded_state": (
        "parallel/sharded.py:parallelize", "parallel/sharded.py:shard_full_state"),
    "train/checkpoint.py:Checkpointer": ("train/checkpoint.py:Checkpoints",),
    "train/packing.py:pack_state": ("train/packing.py:FlatGroup",),
    "train/packing.py:make_packed_step": (
        "train/packing.py:PackedTrainState", "train/packing.py:make_fused_train_step"),
    "train/trainer.py:TrainState": ("train/packing.py:PackedTrainState",),
}

# JAX name ("path:name", or a module "path") -> why the port has none
NO_COUNTERPART = {
    "models/ctrgcn_infer.py:nn_relu": "jax.nn.relu under a name of its own; the port calls "
                                      "torch.relu",
    "ops/inits.py:conv_branch_init": "no model of the JAX package calls it (the reference's "
                                     "branch init of a module neither package has)",
    "ops/inits.py:constant": "a Flax initializer factory; the port fills in place with "
                             "torch.nn.init.constant_",
    "ops/inits.py:bn_scale_init": "a Flax initializer factory (a constant scale); the port "
                                  "fills in place with torch.nn.init.constant_ "
                                  "(models/ctrgcn.py, bn_init of gcn1.bn at 1e-6)",
    "parallel/mesh.py:batch_sharding": "a JAX sharding spec; the port's ranks own their slices "
                                       "(parallel/mesh.py:data_slice, shard_batch)",
    "parallel/mesh.py:replicated": "a JAX sharding spec; a replicated tensor is a whole copy "
                                   "on each rank, kept one by parallel/sharded.py:GradientSum",
    "utils/cache.py": "XLA's persistent compilation cache; ops/cuda/build.py's hash-keyed "
                      "_build/ keeps the built kernels",
    "utils/roofline.py:ChipSpec": "TPU chip specs; the port's bounds are the H100's "
                                  "(utils/roofline.py:bound)",
    "utils/roofline.py:detect_chip": "picks a TPU generation; the port runs on one H100",
    "utils/timing.py:time_step_chained": "times a jitted step fed its own state; the port "
                                         "times a step as a CUDA graph (utils/timing.py:graph_ms)",
}

# PERF.md's kernel table row -> the port's CUDA sources
KERNEL_ROWS = {
    "K1": ("unit_ctr_gc_fwd.cu",),
    "K2": ("unit_ctr_gc_bwd_dx3.cu",),
    "K3": ("unit_ctr_gc_bwd_param.cu", "unit_ctr_gc_bwd_param_bf16.cu"),
    "K4": ("ctr_gc_fused.cu",),
    "K5": ("gcn_tcn_block.cu",),
    "K6": ("unit_ctr_gc_bwd_conv3.cu",),
    "T1": ("ms_tcn.cu",),
    "T2": ("stage2_aggregate.cu",),
}

# "file:enclosing function" of each pl.pallas_call -> its row
PALLAS_SITES = {
    "tamgcn_tpu/ops/pallas/ctr_gc.py:_fused_pallas_call": "K4",
    "tamgcn_tpu/ops/pallas/ctr_gc.py:unit_ctr_gc_fwd_pallas": "K1",
    "tamgcn_tpu/ops/pallas/ctr_gc.py:unit_ctr_gc_bwd_pallas": "K2",
    "tamgcn_tpu/ops/pallas/ctr_gc.py:_unit_param_grads": "K3",
    "tamgcn_tpu/ops/pallas/ctr_gc.py:unit_ctr_gc_bwd_conv3_pallas": "K6",
    "tamgcn_tpu/ops/pallas/gcn_tcn_block.py:gcn_tcn_block_fused": "K5",
    "tools/exp_ms_tcn.py:ms_tcn_fused": "T1",
    "tools/exp_stage2.py:make_floor.call": "T2",
    "tools/exp_stage2.py:win_call": "T2",
    "tools/exp_stage2.py:make_tile.call": "T2",
    "tools/exp_stage2.py:flat_call": "T2",
    "tools/exp_stage2b.py:make_tile.call": "T2",
    # the tuning and decomposition probes launch K4's, K2's and K3's math
    "tools/tune_ctr_gc.py:make_diag_variant.run": "K4",
    "tools/tune_ctr_gc.py:make_einsum_variant.run": "K4",
    "tools/exp_bwd_decomp.py:bench_bwd_split.dx3_only": "K2",
    "tools/exp_bwd_decomp.py:bench_bwd_split.param_only": "K3",
}

TOOLS_RENAMED = {"bench_bf16_convergence.py": "bf16_convergence.py"}

_PROBE = "a JAX timing probe of TPU schedule knobs, with no Pallas body of its own to port"
TOOLS_NOT_PORTED = {
    "bench_scaling.py": "models TPU ICI scaling; not queued",
    "scaling_model.py": "models TPU ICI scaling; not queued",
    "exp_bwd2.py": _PROBE,
    "exp_epilogue.py": _PROBE,
    "exp_stage2c.py": _PROBE,
    "exp_step_ablation.py": _PROBE,
    "exp_tcn.py": _PROBE,
    "tune_ctr_gc.py": "a JAX timing probe of TPU schedule knobs; its Pallas bodies are K4's "
                      "math (PALLAS_SITES)",
    "exp_bwd_decomp.py": "a JAX timing probe of TPU schedule knobs; its Pallas bodies are K2's "
                         "and K3's (PALLAS_SITES)",
    "export_flax_npz.py": "JAX-side: writes a JAX checkpoint as a Flax .npz, which the port's "
                          "--weights reads (train/checkpoint.py:read_weights)",
    "export_torch_weights.py": "the port reads a reference .pt directly "
                               "(train/checkpoint.py:read_weights)",
    "gen_skeletons_pose.py": "needs a pose model and packages the repository does not have; "
                             "not queued",
}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public(path: pathlib.Path) -> list:
    """The public top-level defs and classes of a module."""
    return [n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _port_has(ref: str) -> bool:
    """A port name "path:name" (a top-level def or class) or a file exists."""
    path, _, name = ref.partition(":")
    file = PORT / path
    if not file.is_file():
        return False
    return not name or any(isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name == name
                           for n in _tree(file).body)


def _unresolved(rel: str) -> list:
    """The public names of tamgcn_tpu/<rel> that resolve to nothing."""
    if rel in RENAMED or rel in NO_COUNTERPART:
        return []
    port = PORT / rel
    have = set(_public(port)) if port.is_file() else set()
    names = [n for n in _public(JAX_PKG / rel)
             if n not in have and f"{rel}:{n}" not in RENAMED
             and f"{rel}:{n}" not in NO_COUNTERPART]
    if not port.is_file() and not names and not any(
            k.startswith(f"{rel}:") for k in (*RENAMED, *NO_COUNTERPART)):
        return ["<the module itself>"]
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_its_counterpart(rel):
    assert _unresolved(rel) == [], (
        f"tamgcn_tpu/{rel}: no namesake in tamgcn_tpu_torch/{rel}, no entry in RENAMED "
        "or NO_COUNTERPART")


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_entries_are_live(key):
    rel, _, name = key.partition(":")
    assert (JAX_PKG / rel).is_file(), f"{key}: no such JAX module"
    if name:
        assert name in _public(JAX_PKG / rel), f"{key}: no such JAX name"
        assert not (PORT / rel).is_file() or name not in _public(PORT / rel), (
            f"{key}: the port has its namesake; drop the entry")
    else:
        assert not (PORT / rel).is_file(), f"{key}: the port has the module; drop the entry"
    refs = RENAMED[key]
    assert refs and [r for r in refs if not _port_has(r)] == []


@pytest.mark.parametrize("key", sorted(NO_COUNTERPART))
def test_no_counterpart_entries_are_live(key):
    rel, _, name = key.partition(":")
    assert (JAX_PKG / rel).is_file(), f"{key}: no such JAX module"
    if name:
        assert name in _public(JAX_PKG / rel), f"{key}: no such JAX name"
        assert not (PORT / rel).is_file() or name not in _public(PORT / rel), (
            f"{key}: the port has its namesake; drop the entry")
    assert NO_COUNTERPART[key].strip()


def _pallas_sites() -> list:
    """"file:enclosing function" of every pl.pallas_call in tamgcn_tpu/
    and tools/ (nested functions joined by dots)."""
    out = []

    def walk(node, stack, rel):
        for child in ast.iter_child_nodes(node):
            inner = stack + [child.name] if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else stack
            if isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute) \
                    and child.func.attr == "pallas_call":
                out.append(f"{rel}:{'.'.join(stack)}")
            walk(child, inner, rel)

    for root in (JAX_PKG, REPO / "tools"):
        for path in sorted(root.rglob("*.py")):
            walk(_tree(path), [], str(path.relative_to(REPO)))
    return out


def test_every_pallas_call_maps_to_a_cuda_source():
    sites = _pallas_sites()
    assert len(sites) >= 16
    assert sorted(set(sites)) == sorted(PALLAS_SITES), (
        "pallas_call sites and PALLAS_SITES differ")
    rows = re.findall(r"^\| (K\d|T\d) \|", (REPO / "PERF.md").read_text(), re.M)
    for site, row in PALLAS_SITES.items():
        assert row in rows, f"{site}: no row {row} in PERF.md's kernel table"
        assert all((CSRC / src).is_file() for src in KERNEL_ROWS[row]), row
    mapped = {src for row in KERNEL_ROWS.values() for src in row}
    assert sorted(p.name for p in CSRC.glob("*.cu")) == sorted(mapped)


@pytest.mark.parametrize("tool", sorted(p.name for p in (REPO / "tools").glob("*.py")))
def test_every_tool_has_its_counterpart(tool):
    port = PORT / "tools" / TOOLS_RENAMED.get(tool, tool)
    if tool in TOOLS_NOT_PORTED:
        assert not port.is_file(), f"{tool}: the port has it; drop the entry"
        assert TOOLS_NOT_PORTED[tool].strip()
    else:
        assert port.is_file(), f"tools/{tool}: no tamgcn_tpu_torch/tools/{port.name}"


def test_tool_tables_are_live():
    tools = {p.name for p in (REPO / "tools").glob("*.py")}
    assert set(TOOLS_RENAMED) | set(TOOLS_NOT_PORTED) <= tools
    assert not set(TOOLS_RENAMED) & set(TOOLS_NOT_PORTED)


def _options(path: pathlib.Path) -> set:
    return {a.value for n in ast.walk(_tree(path))
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant) and isinstance(a.value, str)}


def test_every_cli_option_is_the_ports():
    want = _options(JAX_PKG / "train" / "config.py")
    assert "--sequence_parallel" in want and len(want) > 40
    assert sorted(want - _options(PORT / "train" / "config.py")) == []


def _subcommands(path: pathlib.Path, function: str) -> set:
    """The string keys of the dicts in `function` and of its subscript
    assignments (main.py adds the cross-modal ones to its registry)."""
    fn = next(n for n in ast.walk(_tree(path))
              if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Dict):
            keys |= {k.value for k in n.keys if isinstance(k, ast.Constant)}
        elif isinstance(n, ast.Assign):
            keys |= {t.slice.value for t in n.targets
                     if isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant)}
    return keys


def test_every_subcommand_is_the_ports():
    want = _subcommands(REPO / "main.py", "_build_registry")
    assert {"recognition", "recognition_fusion"} <= want
    assert sorted(want - _subcommands(PORT / "__main__.py", "_registry")) == []
