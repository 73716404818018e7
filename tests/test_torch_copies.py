"""The port's copies of the framework-free modules stay copies.

The port keeps its own copy of every JAX-free module it needs, with the
imports rewritten (``repro.`` -> ``repro_torch.``).  Each copy's syntax
tree, docstrings stripped, must equal the reference's; the reference is
read as source text, never imported.  The copied simulator must also give
the reference's results for each policy.

One partial copy, named in ``PARTIAL``: ``launch/dryrun.py``, whose
rules (``_FSDP_ARCHS``, ``rules_for``, ``opt_rules_for``,
``decode_rules``) the port copies; the rest of the reference's module
(the cell accounting, the HLO walk) is not ported yet.  Those names'
syntax trees are compared one by one, and the port's module holds nothing
else but its imports, ``__all__`` and the names in ``OWN``:
``serve_rules``, the composition of those rules that the reference's
``run_cell`` writes inline for a decode cell, held against it by the
layouts it gives every parameter and cache leaf of every registry arch.

One translation, named in ``TRANSLATED``: the port's ``plan_for_ctx``
(``transfer/shard.py``) takes the process index from its own
``distributed.context.process_index``, where the reference imports JAX
and calls ``jax.process_index()``.  Those two spellings are mapped onto
the reference's in the port's source before it is parsed; the rest of the
file, that function included, is compared as it stands.  (Until the port
had a sharding context it left ``plan_for_ctx`` out; ``LEFT_OUT`` names
no function now.)
"""

import ast
import dataclasses
import os

import pytest

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SRC = os.path.join(_ROOT, "src")

COPIES = [
    "core/chunking.py", "core/throughput.py", "core/simulator.py",
    "core/mdtp.py", "core/static_chunking.py", "core/aria2.py",
    "core/bittorrent.py", "core/scenarios.py",
    "transfer/journal.py", "transfer/codec.py", "transfer/transport.py",
    "transfer/server.py",
    "transfer/sched/__init__.py", "transfer/sched/core.py",
    "transfer/sched/defaults.py",
    "transfer/sink.py", "transfer/mirror.py", "transfer/manager.py",
    "transfer/shard.py",
    "data/pipeline.py", "data/__init__.py",
]

#: module -> top-level names the port leaves out of its copy (none now)
LEFT_OUT: dict = {}

#: module -> (port spelling, reference spelling) pairs substituted in the
#: port's source text before it is parsed
TRANSLATED = {"transfer/shard.py": [
    ("from repro_torch.distributed.context import process_index\n",
     "import jax\n"),
    ("host = process_index() %", "host = jax.process_index() %"),
]}


#: module -> the top-level names the port copies of it (the rest of the
#: reference's module is not ported)
PARTIAL = {"launch/dryrun.py": ("_FSDP_ARCHS", "rules_for", "opt_rules_for",
                                "decode_rules")}
#: module -> the port's own top-level names beside a partial copy
OWN = {"launch/dryrun.py": ("serve_rules",)}


class _Normalize(ast.NodeTransformer):
    """Drop docstrings; map ``repro`` imports onto ``repro_torch``; drop
    the top-level functions named in ``left_out`` and their ``__all__``
    entries."""

    def __init__(self, left_out=()):
        self.left_out = set(left_out)

    def visit_Module(self, node):
        node.body = [n for n in node.body
                     if not (isinstance(n, ast.FunctionDef)
                             and n.name in self.left_out)]
        for n in node.body:
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and n.targets[0].id == "__all__"
                    and isinstance(n.value, ast.List)):
                n.value.elts = [e for e in n.value.elts
                                if not (isinstance(e, ast.Constant)
                                        and e.value in self.left_out)]
        return self._strip(node)

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_ClassDef = _strip
    visit_FunctionDef = visit_AsyncFunctionDef = _strip

    def visit_ImportFrom(self, node):
        if node.module and (node.module == "repro"
                            or node.module.startswith("repro.")):
            node.module = "repro_torch" + node.module[len("repro"):]
        return node

    def visit_Import(self, node):
        for alias in node.names:
            if alias.name == "repro" or alias.name.startswith("repro."):
                alias.name = "repro_torch" + alias.name[len("repro"):]
        return node


def _source(pkg: str, rel: str) -> str:
    with open(os.path.join(_SRC, pkg, rel)) as f:
        text = f.read()
    if pkg == "repro_torch":
        for port, ref in TRANSLATED.get(rel, ()):
            assert text.count(port) == 1, (rel, port)
            text = text.replace(port, ref)
    return text


def _tree(pkg: str, rel: str) -> str:
    tree = ast.parse(_source(pkg, rel), os.path.join(_SRC, pkg, rel))
    return ast.dump(_Normalize(LEFT_OUT.get(rel, ())).visit(tree))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_ast_equal_to_the_reference(rel):
    assert _tree("repro_torch", rel) == _tree("repro", rel), (
        f"src/repro_torch/{rel} no longer matches src/repro/{rel} "
        f"(docstrings and the package name aside)")


def test_normalizer_sees_a_changed_body():
    """The comparison is not vacuous: a changed constant shows."""
    a = ast.dump(_Normalize().visit(ast.parse('"""d"""\nx = 1\n')))
    b = ast.dump(_Normalize().visit(ast.parse('"""e"""\nx = 2\n')))
    c = ast.dump(_Normalize().visit(ast.parse('"""e"""\nx = 1\n')))
    assert a != b and a == c


def test_left_out_is_only_what_the_port_omits():
    """The port now omits nothing of ``transfer/shard.py``: ``plan_for_ctx``
    is in both packages and their ``__all__``; the translation is narrow
    (each pair matches once, and without it the trees differ, so the
    function's body is really compared); a left-out name would still drop
    only itself."""
    import repro_torch.transfer.shard as port_shard

    rel = "transfer/shard.py"
    assert LEFT_OUT == {}
    assert callable(port_shard.plan_for_ctx)
    assert "plan_for_ctx" in port_shard.__all__
    with open(os.path.join(_SRC, "repro_torch", rel)) as f:
        raw = ast.dump(_Normalize().visit(ast.parse(f.read())))
    assert raw != _tree("repro", rel)
    assert _tree("repro_torch", rel) == _tree("repro", rel)
    code = 'def f():\n    pass\ndef g():\n    pass\n__all__ = ["f", "g"]\n'
    kept = _Normalize({"f"}).visit(ast.parse(code))
    assert [n.name for n in kept.body[:-1]] == ["g"]
    assert [e.value for e in kept.body[-1].value.elts] == ["g"]


@pytest.mark.parametrize("policy", ["MDTPPolicy", "StaticChunkingPolicy",
                                    "Aria2Policy", "BitTorrentPolicy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_copied_simulator_gives_the_reference_result(policy, seed):
    import repro.core as ref
    import repro.core.scenarios as ref_scen
    import repro_torch.core as port
    import repro_torch.core.scenarios as port_scen

    size = 256 * 1024 * 1024
    a = ref.simulate(getattr(ref, policy)(), ref_scen.paper_baseline(),
                     size, seed=seed)
    b = port.simulate(getattr(port, policy)(), port_scen.paper_baseline(),
                      size, seed=seed)
    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    assert a == b
    assert b["total_time"] > 0 and sum(b["bytes_per_server"]) == size


def _top_names(node) -> list:
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    return []


def _named(pkg: str, rel: str, names) -> dict:
    tree = ast.parse(_source(pkg, rel), os.path.join(_SRC, pkg, rel))
    out = {}
    for node in tree.body:
        for name in _top_names(node):
            if name in names:
                mod = ast.Module(body=[node], type_ignores=[])
                out[name] = ast.dump(_Normalize().visit(mod))
    return out


@pytest.mark.parametrize("rel", sorted(PARTIAL))
def test_partial_copy_is_ast_equal_where_it_copies(rel):
    names = PARTIAL[rel]
    port, ref = _named("repro_torch", rel, names), _named("repro", rel, names)
    assert sorted(port) == sorted(names) == sorted(ref)
    for name in names:
        assert port[name] == ref[name], (
            f"{name} of src/repro_torch/{rel} no longer matches "
            f"src/repro/{rel}")
    tree = ast.parse(_source("repro_torch", rel))
    rest = [n for n in tree.body[1:]
            if not isinstance(n, (ast.Import, ast.ImportFrom))
            and set(_top_names(n)) - {"__all__"} - set(names)
            - set(OWN.get(rel, ()))]
    assert rest == [], "the port's partial copy holds more than its names"


def _reference_dryrun():
    """``repro.launch.dryrun``, whose import adds 512 forced host devices
    to ``XLA_FLAGS``: the variable is put back at once (it is read when
    JAX's backend starts, which the import does not do)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 16)])
def test_serve_rules_are_the_reference_decode_cell_composition(shape):
    """For every registry arch and batch in {1, 4, 16}: ``serve_rules``
    lays out every parameter as the reference's ``run_cell`` stores it
    (``rules_for``'s storage rules) and every cache leaf ``init_cache``
    cuts to a rank's block -- KV leaves, recurrent states, and the
    ``memory`` of encdec and vlm by its batch rows -- as it decodes it
    (``decode_rules`` of the compute rules at the mesh's model size), and
    its rules are ``decode_rules`` of the storage rules."""
    import repro.configs as jax_configs

    from repro_torch.configs import get_config, list_archs
    from repro_torch.distributed import Mesh, ShardingRules
    from repro_torch.distributed.context import KV_CACHE_LOGICAL, ShardingCtx
    from repro_torch.launch import dryrun
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import cache_specs, model_specs

    ref = _reference_dryrun()
    D, M = shape
    mesh = Mesh(shape, ("data", "model"))
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jax_configs.get_config(arch)
        compute, storage = ref.rules_for(jcfg, False)
        for batch in (1, 4, 16):
            mine = dryrun.serve_rules(cfg, mesh, batch)
            assert mine.rules == ref.decode_rules(jcfg, storage, batch,
                                                  M).rules
            ours = ShardingCtx(mesh, mine)
            theirs_p = ShardingCtx(mesh, ShardingRules(storage.rules))
            theirs_c = ShardingCtx(mesh, ShardingRules(ref.decode_rules(
                jcfg, compute, batch, M).rules))
            for key, sp in tree_leaves(model_specs(cfg)):
                assert ours.spec(sp.logical, sp.shape) == theirs_p.spec(
                    sp.logical, sp.shape), (arch, batch, key)
            for key, sp in tree_leaves(cache_specs(cfg, batch, 4096, 8)):
                if key == "memory":     # init_cache cuts its batch rows
                    assert _entries(ours.spec(("batch",), (batch,)), 3,
                                    3) == _entries(theirs_c.spec(
                                        sp.logical, sp.shape), 3, 3), (
                        arch, batch, key)
                    continue
                # init_cache cuts a leaf's own dims, the layers' stay whole
                lead = int(sp.logical[0] == "layers")
                n = len(sp.shape) - lead
                if key.rsplit("/", 1)[-1] in ("k", "v"):
                    assert sp.logical[lead:] == KV_CACHE_LOGICAL, (arch, key)
                assert _entries(ours.spec(sp.logical[lead:], sp.shape[lead:]),
                                n, n) == _entries(theirs_c.spec(
                                    sp.logical, sp.shape), len(sp.shape), n), (
                    arch, batch, key)


def _entries(spec, ndim: int, last: int = 4) -> list:
    """The axes of the ``last`` of a spec's ``ndim`` dims, as tuples (a
    spec leaves out its trailing whole dims)."""
    from repro_torch.distributed.context import _axes

    out = [tuple(_axes(e)) for e in spec]
    return (out + [()] * (ndim - len(out)))[-last:]
