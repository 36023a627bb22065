"""The port's public surface against the JAX package's, read from both
packages' sources with ast: no module of either package is imported.

* test_module_surface[<module>]: for every .py under text2loc_tpu/ but the
  Pallas files (ops/pallas_*.py), each public top-level def or class, and
  each public method or property of a public class that the port keeps
  under the same name, exists in the port's module of the same path
  (MODULE_MOVED: the one module the port renamed), or MOVED names what
  takes its place in the port (which must exist), or NOT_PORTED gives the
  reason it has no twin; MODULES_NOT_PORTED closes whole modules. An entry
  of the tables that names nothing of the JAX package, or a name the port
  has at the same path, fails too, so the tables cannot go stale.
* test_kernel_ported[<function>]: every JAX function whose own body calls
  pl.pallas_call maps in KERNELS to the port's wrapper and its csrc/
  sources, which must exist.
* test_env_knob[<variable>]: every environment variable the JAX package
  reads (TEXT2LOC_*, JAX_COMPILATION_CACHE_DIR) maps in ENV to the port's
  twin, an argument that must exist, or to the reason it has none.

A target is "path.py:Name", "path.py:Class.member" (a method, a property,
a class field or an attribute set on self) or either with "(arg, ...)",
arguments the function must take; paths are relative to the package.
Each mapping below was made by reading both functions.
"""

import ast
import functools
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "text2loc_tpu")
PORT = os.path.join(REPO, "text2loc_tpu_torch")

MODULE_MOVED = {"models/torch_convert.py": "torch_checkpoint.py"}

MODULES_NOT_PORTED = {
    "native/__init__.py": "the optional C++ helpers of the numpy prep: the port's prep runs "
                          "on the card (voxels in prep/voxel.py), fine_object_order and "
                          "pmc_rematch have numpy copies in data/arrays.py and data/pmc.py",
    "utils/compile_cache.py": "XLA's persistent compilation cache: the port compiles no XLA "
                              "or Inductor program; its kernels build once per source hash "
                              "under build/ (ops/_cuda.py)",
}

MOVED = {
    # MeshConfig's two fields (dp=-1: every device; axis_name "dp") are
    # make_mesh's arguments, with the same defaults, in both packages.
    "config.py:MeshConfig": ("parallel/mesh.py:make_mesh(num_devices, axis_name)",),
    # (build_table, encode): the [V, D] trunk table, then a row gather and
    # the cross-sentence head per query; the port's eval loop does both.
    "evaluation/retrieval.py:make_sentence_table_text_encoder": (
        "evaluation/retrieval.py:build_vocab_sentence_table",
        "evaluation/retrieval.py:encode_queries_table"),
    "models/pointnet2.py:fused_train_auto": (
        # what TEXT2LOC_FUSED_SA_TRAIN "auto" resolves to per stage
        "training/steps.py:default_fused_train(cfg, kind)",
        "convert.py:build_model(fused_train)"),
    # Binds the mesh for the training SA levels' global statistics; the
    # port's DP step binds it to every module that computes across rows.
    "models/pointnet2.py:fused_train_mesh": ("parallel/mesh.py:use_mesh(model, mesh)",),
    "models/torch_convert.py:load_torch_tower": (
        "torch_checkpoint.py:load_reference_checkpoint(model, path, cfg, kind)",),
    "models/transformer.py:TorchEncoderLayer": ("models/transformer.py:EncoderLayer",),
    "models/transformer.py:TorchDecoderLayer": ("models/transformer.py:DecoderLayer",),
    "data/prefetch.py:prefetch_enabled": ("training/coarse.py:train_coarse(prefetch)",
                                          "training/fine.py:train_fine(prefetch)"),
    # The JAX serve keeps TrainStates; the port's keeps the eval-mode models.
    "serving.py:Localizer.coarse_state": ("serving.py:Localizer.coarse_model",),
    "serving.py:Localizer.fine_state": ("serving.py:Localizer.fine_model",),
    "training/fine.py:make_fine_optimizer": (
        "training/steps.py:make_fine_optimizer(params, cfg, steps_per_epoch)",),
    # Inference-mode encode_objects / encode_text over the gallery and the
    # queries.
    "training/steps.py:make_coarse_encoders": ("evaluation/retrieval.py:encode_gallery",
                                               "evaluation/retrieval.py:encode_queries"),
    # The split forwards are CrossMatch's own methods in the port (eager
    # PyTorch needs no jitted closure per split).
    "training/steps.py:FineSplitForwards": (
        "models/cross_matcher.py:CrossMatch.encode_objects",
        "models/cross_matcher.py:CrossMatch.encode_hints",
        "models/cross_matcher.py:CrossMatch.cct",
        "models/cross_matcher.py:CrossMatch.refine",
        "models/cross_matcher.py:CrossMatch.cct_obj_pre",
        "models/cross_matcher.py:CrossMatch.cct_hints_pre",
        "models/cross_matcher.py:CrossMatch.cct_tail"),
    "training/steps.py:make_fine_split_forwards": ("models/cross_matcher.py:CrossMatch",),
    # obj_pre=True; with obj_pre=False it is CrossMatch.encode_objects over
    # the gathered cells.
    "training/steps.py:encode_fine_gallery": (
        "evaluation/retrieval.py:encode_fine_gallery(data, model, cfg, device, cell_indices, "
        "chunk)",
        "models/cross_matcher.py:CrossMatch.encode_objects"),
    # flax's init: the port builds the module, seeds its weights and pairs
    # it with its optimizer.
    "training/steps.py:init_train_state": ("convert.py:init_weights(model, generator)",
                                           "training/steps.py:TrainState"),
}

_FLAX_SETUP = "flax's set-up hook: a torch module builds its layers in __init__"
NOT_PORTED = {
    "models/cell_retrieval.py:CellRetrievalNetwork.setup": _FLAX_SETUP,
    "models/cross_matcher.py:CrossMatch.setup": _FLAX_SETUP,
    "models/language_encoder.py:LanguageEncoder.setup": _FLAX_SETUP,
    "models/pointnet2.py:suppress_fused_train": (
        "GSPMD cannot partition a Mosaic call; the port's DP step runs the training SA "
        "kernels on every rank with all-reduced statistics (parallel/train.py)"),
    "models/transformer.py:grouped_dot_product_attention": (
        "TEXT2LOC_GROUPED_ATTN's fold, measured slower on the H100 "
        "(scripts/probe_torch_grouped.py); ROADMAP 'Deliberate differences'"),
    "parallel/mesh.py:batch_sharding": (
        "a jax NamedSharding: each rank of the port holds its own rows (shard_batch)"),
    "parallel/mesh.py:replicated_sharding": (
        "a jax NamedSharding: replicated state is a plain tensor on every rank, made "
        "equal by broadcast_ (parallel/train.replicate_state)"),
    "utils/debug.py:enable_disable_jit": "eager PyTorch has no jit to turn off",
}

# JAX function -> (the port's wrapper, its csrc/ sources).
KERNELS = {
    "ops/pallas_fps.py:farthest_point_sampling_pallas": (
        "ops/cuda_fps.py:farthest_point_sampling_cuda", ("fps.cu",)),
    "ops/pallas_pointconv.py:fused_sa_select": (
        "ops/cuda_pointconv.py:sa_select_cuda(selection)",
        ("sa_select.cu", "sa_select_bisect.cu", "sa_select_tc.cuh")),
    "ops/pallas_pointconv.py:fused_sa_gather": (
        "ops/cuda_pointconv.py:sa_gather_cuda", ("sa_gather.cu", "sa_select_tc.cuh")),
    "ops/pallas_pointconv.py:fused_set_abstraction": (
        "ops/cuda_pointconv.py:set_abstraction_cuda(select_k)",
        ("sa_exact.cu", "sa_all.cu", "sa_select_tc.cuh")),
    "ops/pallas_mha.py:fused_mha_addlayernorm": (
        "ops/cuda_mha.py:mha_addln_cuda", ("mha_addln.cu", "mha_tiled.cu", "gemm_wgmma.cuh")),
    "ops/pallas_ffn.py:fused_ffn_addlayernorm": (
        "ops/cuda_ffn.py:ffn_addln_cuda", ("ffn_addln.cu", "ffn_tiled.cu", "gemm_wgmma.cuh")),
    "ops/pallas_ln.py:fused_add_layernorm": (
        "ops/cuda_ln.py:add_layernorm_cuda", ("add_ln.cu", "layernorm_rows.cuh")),
    "ops/pallas_gather.py:gather_rows_pallas": (
        "ops/cuda_gather.py:gather_rows_cuda", ("gather_rows.cu",)),
    "ops/pallas_gather.py:_gather_tiled": (
        "ops/cuda_gather.py:gather_rows_cuda", ("gather_rows.cu",)),
    "ops/pallas_gather.py:_scatter_tiled": (
        "ops/cuda_gather.py:scatter_rows_cuda", ("gather_rows.cu",)),
    "ops/pallas_sa_train.py:_forward": (
        "ops/sa_train.py:forward_cuda", ("sa_train_fwd.cu", "sa_train_fwd.cuh")),
    "ops/pallas_sa_train.py:_backward": (
        "ops/sa_train.py:backward_cuda", ("sa_train_bwd.cu", "sa_train_bwd.cuh")),
    # cache bf16 ("e"): cuda_sa_train.Level(..., cache_dtype=bf16) takes
    # these two kernels.
    "ops/pallas_sa_train.py:_forward_e": (
        "ops/sa_train.py:forward_cuda", ("sa_train_e_fwd.cu", "sa_train_fwd.cuh")),
    "ops/pallas_sa_train.py:_backward_e": (
        "ops/sa_train.py:backward_cuda", ("sa_train_e_bwd.cu", "sa_train_bwd.cuh")),
}

_NO_XLA = "no TPU tile or XLA program in the port"
ENV = {
    "TEXT2LOC_FUSED_ATTN": "convert.py:build_model(fused_attn)",
    "TEXT2LOC_FUSED_FFN": "convert.py:build_model(fused_ffn)",
    "TEXT2LOC_FUSED_LN": "convert.py:build_model(fused_ln)",
    "TEXT2LOC_FUSED_SA": "convert.py:build_model(sa_mode)",
    "TEXT2LOC_FUSED_SA_TRAIN": "convert.py:build_model(fused_train)",
    # "0": the plain train branch with the global BatchNorm under a mesh.
    "TEXT2LOC_FUSED_SA_TRAIN_DP": "convert.py:build_model(fused_train)",
    "TEXT2LOC_APPROX_NEIGHBORS": "convert.py:build_model(approx_neighbors)",
    "TEXT2LOC_BISECT_ITERS": "convert.py:build_model(bisect_iters)",
    "TEXT2LOC_VMEM_GATHER": "convert.py:build_model(vmem_gather)",
    "TEXT2LOC_PREFETCH": "training/coarse.py:train_coarse(prefetch)",
    "TEXT2LOC_DISABLE_PALLAS": None,
    "TEXT2LOC_FPS_TILE": None,
    "TEXT2LOC_FUSED_ATTN_ROWS": None,
    "TEXT2LOC_FUSED_SA_ECACHE_GB": None,
    "TEXT2LOC_GROUPED_ATTN": None,
    "TEXT2LOC_APPROX_TOPK": None,
    "JAX_COMPILATION_CACHE_DIR": None,
}
# The reasons of ROADMAP "Environment knobs" for the knobs without a twin.
ENV_REASONS = {
    "TEXT2LOC_DISABLE_PALLAS": "a switch that turns a kernel off, which the port may not have",
    "TEXT2LOC_FPS_TILE": f"a TPU tile size: {_NO_XLA}",
    "TEXT2LOC_FUSED_ATTN_ROWS": f"a TPU tile size: {_NO_XLA}",
    "TEXT2LOC_FUSED_SA_ECACHE_GB": "the cached-edge budget: the port caches no edges",
    "TEXT2LOC_GROUPED_ATTN": "the grouped fold, measured slower on the H100",
    "TEXT2LOC_APPROX_TOPK": "a TPU-only speed path, exact top_k elsewhere; waits for a "
                            "benchmark cell",
    "JAX_COMPILATION_CACHE_DIR": "utils/compile_cache.py is not ported (MODULES_NOT_PORTED)",
}


def _jax_modules() -> list:
    out = []
    for root, _, files in os.walk(JAX):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), JAX).replace(os.sep, "/")
            if f.endswith(".py") and not rel.startswith("ops/pallas_"):
                out.append(rel)
    return sorted(out)


@functools.lru_cache(maxsize=None)
def _tree(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _members(cls: ast.ClassDef) -> dict:
    """Methods, properties, class fields and attributes set on self."""
    out = {}
    for n in cls.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[n.name] = n
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out[n.target.id] = n
        elif isinstance(n, ast.Assign):
            out.update((t.id, n) for t in n.targets if isinstance(t, ast.Name))
    for n in ast.walk(cls):
        targets = (n.targets if isinstance(n, ast.Assign)
                   else [n.target] if isinstance(n, (ast.AnnAssign, ast.AugAssign)) else [])
        for t in targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                out.setdefault(t.attr, n)
    return out


def _defs(path: str) -> dict:
    """{name or Class.member: node} of a module's top level."""
    out = {}
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[n.name] = n
        if isinstance(n, ast.ClassDef):
            out.update((f"{n.name}.{m}", node) for m, node in _members(n).items())
    return out


def _public(path: str) -> list:
    """The public top-level defs and classes of a JAX module, and the public
    methods of its public classes (Class.method)."""
    out = []
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not n.name.startswith("_"):
            out.append(n.name)
            if isinstance(n, ast.ClassDef):
                out += [f"{n.name}.{m.name}" for m in n.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")]
    return out


def _args(node) -> set:
    a = node.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}


def _resolve(target: str, root: str = PORT) -> None:
    """Assert that `target` exists under `root` (see the module docstring)."""
    m = re.fullmatch(r"([\w/]+\.py):([\w.]+)(?:\((.*)\))?", target)
    assert m, f"malformed target {target!r}"
    path = os.path.join(root, m.group(1))
    assert os.path.isfile(path), f"{target}: no file {path}"
    node = _defs(path).get(m.group(2))
    assert node is not None, f"{target}: {m.group(2)} is not defined in {m.group(1)}"
    if m.group(3):
        assert isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)), target
        missing = {a.strip() for a in m.group(3).split(",")} - _args(node)
        assert not missing, f"{target}: no argument {sorted(missing)}"


def _pallas_functions() -> dict:
    """{"ops/pallas_x.py:qualified.name": lineno} of every JAX function
    whose own body (not a nested def) calls pl.pallas_call."""
    found = {}

    def own_call(fn) -> bool:
        stack = list(fn.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                continue
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "pallas_call"):
                return True
            stack.extend(ast.iter_child_nodes(n))
        return False

    def walk(node, rel, prefix):
        for n in ast.iter_child_nodes(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if own_call(n):
                    found[f"{rel}:{prefix}{n.name}"] = n.lineno
                walk(n, rel, f"{prefix}{n.name}.")
            elif isinstance(n, ast.ClassDef):
                walk(n, rel, f"{prefix}{n.name}.")
            else:
                walk(n, rel, prefix)

    for f in sorted(os.listdir(os.path.join(JAX, "ops"))):
        if f.startswith("pallas_") and f.endswith(".py"):
            walk(_tree(os.path.join(JAX, "ops", f)), f"ops/{f}", "")
    return found


def _env_reads() -> set:
    """Every string constant of the JAX package that names an environment
    variable it reads."""
    names = set()
    for rel in _jax_modules() + [f"ops/{f}" for f in os.listdir(os.path.join(JAX, "ops"))
                                 if f.startswith("pallas_")]:
        for n in ast.walk(_tree(os.path.join(JAX, rel))):
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and re.fullmatch(
                    r"TEXT2LOC_[A-Z0-9_]+|JAX_COMPILATION_CACHE_DIR", n.value):
                names.add(n.value)
    return names


MODULES = _jax_modules()


def test_tables_name_jax_modules():
    """Every module the tables name is a JAX module the surface test walks."""
    named = {k.split(":")[0] for k in (*MOVED, *NOT_PORTED)}
    assert not (named | set(MODULE_MOVED) | set(MODULES_NOT_PORTED)) - set(MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_module_surface(rel):
    names = _public(os.path.join(JAX, rel))
    for key in (*MOVED, *NOT_PORTED):
        if key.startswith(rel + ":"):
            assert key.split(":", 1)[1] in names, f"{key}: not a public name of the JAX module"
    if rel in MODULES_NOT_PORTED:
        assert MODULES_NOT_PORTED[rel]
        return
    port = os.path.join(PORT, MODULE_MOVED.get(rel, rel))
    assert os.path.isfile(port), f"{rel}: the port has no {port}"
    have = _defs(port)
    port_classes = {k for k, v in have.items() if isinstance(v, ast.ClassDef)}
    missing = []
    for name in names:
        key = f"{rel}:{name}"
        if "." in name and name.split(".")[0] not in port_classes:
            continue            # a method of a class the port moved or left out
        if key in MOVED:
            assert name not in have, f"{key}: in the port at the same path; drop it from MOVED"
            for target in MOVED[key]:
                _resolve(target)
        elif key in NOT_PORTED:
            assert name not in have, f"{key}: in the port; drop it from NOT_PORTED"
            assert NOT_PORTED[key]
        elif name not in have:
            missing.append(name)
    assert not missing, f"{rel}: not in the port, not moved, no reason given: {missing}"


@pytest.mark.parametrize("fn", sorted(set(_pallas_functions()) | set(KERNELS)))
def test_kernel_ported(fn):
    assert fn in _pallas_functions(), f"{fn}: calls no pl.pallas_call (a stale entry)"
    assert fn in KERNELS, f"{fn}: reaches pl.pallas_call and has no port kernel"
    wrapper, sources = KERNELS[fn]
    _resolve(wrapper)
    for src in sources:
        assert os.path.isfile(os.path.join(PORT, "csrc", src)), f"{fn}: no csrc/{src}"


@pytest.mark.parametrize("var", sorted(_env_reads() | set(ENV)))
def test_env_knob(var):
    assert var in _env_reads(), f"{var}: the JAX package does not read it (a stale entry)"
    assert var in ENV, f"{var}: read by the JAX package, with no twin or reason in the port"
    if ENV[var] is None:
        assert ENV_REASONS.get(var), f"{var}: neither a twin nor a reason"
    else:
        assert var not in ENV_REASONS
        _resolve(ENV[var])
