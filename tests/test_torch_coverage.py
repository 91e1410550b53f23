"""The port's completeness against the JAX package, read from the sources
with ``ast`` (nothing of either package is imported).

Every public module-level function or class of joint_tensorf_tpu/ has a
counterpart in joint_tensorf_tpu_torch/: a module-level definition of the
same name in the same module path, or an entry in RENAMED naming the port
attribute that does its work (a JAX design the port replaced: the shading
factories by nn.Module heads, the sharding specs by each rank's blocks and
explicit collectives, the jitted step makers by the eager step).  Each
entry's target exists, and no entry names a JAX function that is gone or
that has a same-named counterpart (a stale entry).  DIFFERS lists the
same-named pairs that compute another function, with the port's name for
JAX's: ``ops/composite.py:composite`` is K1's wrapper from alpha in the
port, where JAX's composites given weights.

The repository's root entry points outside the package have theirs too
(ROOT_MODULES): every module-level function or class of
``__graft_entry__.py`` and ``scripts/run_experiments.py``, private names
included, is defined in the port module that stands for it, but for the
names in ROOT_NOT_CARRIED: each exists in its root module, is absent from
the port module, and has the reason the port does not carry it.  Root
``bench.py`` has no counterpart: it is a TPU measurement entry point,
like the TPU measurement scripts under ``scripts/``, and the port is
measured by ``benchmark/`` (``python3 -m benchmark.run``).
"""
import ast
import functools
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "joint_tensorf_tpu", ROOT / "joint_tensorf_tpu_torch"

RENAMED = {
    "models/shading.py:ShadingHead": "models/shading.py:Head",
    "models/shading.py:make_mlp_fea": "models/shading.py:MLPFea",
    "models/shading.py:make_mlp_fea_weakview":
        "models/shading.py:MLPFeaWeakView",
    "models/shading.py:make_mlp_pe": "models/shading.py:MLPPE",
    "models/shading.py:make_mlp": "models/shading.py:MLP",
    "models/shading.py:make_mlp_albedo": "models/shading.py:MLPAlbedo",
    "models/shading.py:make_garf": "models/shading.py:GaRF",
    "models/shading.py:make_sh": "models/shading.py:SH",
    "models/shading.py:make_rgb": "models/shading.py:RGB",
    "models/shading.py:make_shading_head": "models/shading.py:make_head",
    "models/vm.py:VMState": "models/vm.py:VMField",
    "ops/pallas_kernels.py:composite_pallas": "ops/composite.py:composite",
    "ops/pallas_kernels.py:composite_reference":
        "ops/composite.py:composite_fwd_plain",
    # xla / segsum / runsum compute one function, which K3 computes
    "ops/sampling.py:set_plane_scatter_impl":
        "ops/segment_scatter.py:scatter_add_rows",
    "parallel/sharding.py:field_sharding": "models/vm.py:factor_block",
    "parallel/sharding.py:state_sharding": "models/vm.py:factor_block",
    "parallel/sharding.py:batch_sharding": "parallel/sharding.py:shard_rays",
    "parallel/sharding.py:shard_state": "convert.py:train_state_from_numpy",
    "parallel/sharding.py:rays_shardmap_vg": "train/step.py:reduce_step",
    "parallel/sharding.py:shard_train_step": "train/step.py:train_step",
    "parallel/sharding.py:shard_render_chunk":
        "parallel/sharding.py:render_sharded",
    "train/barf_trainer.py:BarfParams": "train/barf_trainer.py:BarfTrainer",
    "train/l2g.py:L2GParams": "train/l2g.py:pose_params",
    "train/l2g.py:init_warp_mlp": "train/l2g.py:WarpMLP",
    "train/l2g.py:warp_mlp_apply": "train/l2g.py:WarpMLP.forward",
    "train/l2g.py:make_l2g_train_step": "train/l2g.py:l2g_train_step",
    "train/step.py:Params": "train/step.py:TrainState",
    "train/step.py:default_scalars": "train/step.py:StepScalars",
    "train/step.py:make_train_step": "train/step.py:train_step",
    "train/step.py:make_render_fn": "train/trainer.py:Trainer.render_views",
    "utils/jax_setup.py:setup_jax": "utils/torch_setup.py:setup_torch",
}

DIFFERS = {"ops/composite.py:composite": "ops/composite.py:composite_weights"}

# root module -> the port module that stands for it
ROOT_MODULES = {"__graft_entry__.py": "graft_entry.py",
                "scripts/run_experiments.py": "run_experiments.py"}
# root module:name -> why the port has no counterpart
ROOT_NOT_CARRIED = {}


@functools.cache
def _module(path: pathlib.Path):
    return ast.parse(path.read_text(), filename=str(path)).body


def _public(path: pathlib.Path) -> list:
    return [n.name for n in _module(path)
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _defined(path: pathlib.Path) -> dict:
    """Module-level definitions and assignments (aliases) of a port
    module: {name: node}."""
    if not path.exists():
        return {}
    out = {}
    for n in _module(path):
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out[n.name] = n
        elif isinstance(n, ast.Assign):
            out.update({t.id: n for t in n.targets
                        if isinstance(t, ast.Name)})
    return out


def _exists(target: str) -> bool:
    """``module/path.py:name`` or ``module/path.py:Class.method`` in the
    port."""
    rel, _, name = target.partition(":")
    head, _, member = name.partition(".")
    node = _defined(PORT / rel).get(head)
    if node is None or not member:
        return node is not None
    return isinstance(node, ast.ClassDef) and any(
        isinstance(b, ast.FunctionDef) and b.name == member
        for b in node.body)


def _jax_names() -> list:
    return [f"{p.relative_to(JAX).as_posix()}:{name}"
            for p in sorted(JAX.rglob("*.py")) for name in _public(p)]


def _same_named(key: str) -> bool:
    rel, _, name = key.partition(":")
    return name in _defined(PORT / rel)


def test_every_jax_name_has_its_counterpart():
    names = _jax_names()
    assert len(names) > 200           # the walk found the package
    missing = [k for k in names if not _same_named(k) and k not in RENAMED]
    assert not missing, f"no counterpart in the port: {missing}"


def test_every_table_entry_names_a_target_that_exists():
    no_target = {k: v for k, v in {**RENAMED, **DIFFERS}.items()
                 if not _exists(v)}
    assert not no_target, f"targets missing from the port: {no_target}"


def test_no_stale_entry():
    names = set(_jax_names())
    gone = [k for k in {**RENAMED, **DIFFERS} if k not in names]
    assert not gone, f"entries for JAX names that are gone: {gone}"
    renamed_but_present = [k for k in RENAMED if _same_named(k)]
    assert not renamed_but_present, (
        f"entries with a same-named counterpart: {renamed_but_present}")
    assert all(_same_named(k) for k in DIFFERS)


def test_root_entry_points_have_their_counterparts():
    for root, port in ROOT_MODULES.items():
        names = [n.name for n in _module(ROOT / root)
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
        assert names, root
        missing = [n for n in names if n not in _defined(PORT / port)
                   and f"{root}:{n}" not in ROOT_NOT_CARRIED]
        assert not missing, f"{root}: no counterpart in {port}: {missing}"
    assert {"_tiny_setup", "entry", "dryrun_multichip"} <= set(
        _defined(PORT / "graft_entry.py"))


def test_root_names_not_carried_are_absent_from_the_port():
    for key, reason in ROOT_NOT_CARRIED.items():
        root, _, name = key.partition(":")
        assert reason
        assert name in [n.name for n in _module(ROOT / root)
                        if isinstance(n, (ast.FunctionDef, ast.ClassDef))], (
            f"{key} is gone from the root module: drop its entry")
        assert name not in _defined(PORT / ROOT_MODULES[root]), (
            f"{key} has a counterpart in the port: drop its entry")
    # root bench.py, the TPU's measurement entry point, is not carried
    assert (ROOT / "bench.py").exists() and not (PORT / "bench.py").exists()
