"""Runs the JAX package's own test files against ``sentinel_tpu_torch``.

The JAX package's test suite (``tests/test_<x>.py``) encodes the
reference's scenarios. ``load_reference(name, namespace, device)`` reads
one such file, rewrites exactly two kinds of import and nothing else:

- ``sentinel_tpu`` / ``sentinel_tpu.*`` become ``sentinel_tpu_torch`` /
  ``sentinel_tpu_torch.*``;
- ``tests.test_<x>`` (a cross-file helper) becomes the port-loaded module
  of ``test_<x>``;

then compiles the tree under the reference's own file name (tracebacks
point at the reference's lines) and hands its tests to pytest through the
caller's module (``tests/test_torch_ref_<group>.py``):

- ``test_*`` functions as ``<stem>__<name>``, ``Test*`` classes as
  ``Test__<stem>__<name>``, the port-loaded module itself (helpers and
  all) as ``port_<stem>``;
- the file's fixtures as ``<stem>__<name>``: each test of the file gets a
  wrapper whose parameters carry the renamed fixtures, so two files of one
  group cannot collide; an autouse fixture becomes a ``usefixtures`` mark
  on the file's own tests only;
- the file's ``pytestmark`` on each of its tests.

Every reference case is of exactly one kind: (a) it runs as written;
(b) a port variant from the group's ``PORT_VARIANTS`` (keyed by the
reference's node id) replaces it, because it reads a JAX-only internal;
(c) ``xfail(strict=True)`` with its caveat, because the JAX package fails
it too; (d) left out with a reason (``EXCLUDED``), only where its subject
exists only in JAX. ``check_accounting`` holds a group to that: every
case the reference file collects is one of the four, and no other.

The harness gives the port's ``engine`` and ``frozen_time`` fixtures, the
mirror of ``tests/conftest.py``, on an explicit device: ``cpu`` unless
``SENTINEL_REFSUITE_DEVICE`` names another (the card run of
``chip_smoke.py`` sets ``cuda``). A reference case that builds an engine
or a service with no device gets the same device through a monkeypatch on
the port's ``resolve_device`` for the length of the group module; the
package's own device policy does not change.

Run on the CPU: ``python -m pytest tests/test_torch_ref_*.py``. This file
imports the standard library, ``pytest``, ``torch`` and
``sentinel_tpu_torch`` only: the card machine has no JAX.
"""

from __future__ import annotations

import ast
import inspect
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import sentinel_tpu_torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
DEVICE = os.environ.get("SENTINEL_REFSUITE_DEVICE", "cpu")
_MODULE_PREFIX = "sentinel_refsuite_port__"
_LOADED: dict = {}


# ---------------------------------------------------------------------------
# the import rewrite
# ---------------------------------------------------------------------------


def _port_name(name: str) -> str:
    """``sentinel_tpu[.x]`` -> ``sentinel_tpu_torch[.x]``; other names as
    they are."""
    if name == "sentinel_tpu" or name.startswith("sentinel_tpu."):
        return "sentinel_tpu_torch" + name[len("sentinel_tpu"):]
    return name


def _helper_stem(name: str):
    """``tests.test_<x>`` -> ``test_<x>``; None for any other module."""
    parts = name.split(".")
    if len(parts) == 2 and parts[0] == "tests" \
            and parts[1].startswith("test_"):
        return parts[1]
    return None


class _ImportRewrite(ast.NodeTransformer):
    """The two import rewrites, and nothing else."""

    def __init__(self, device: str):
        self.device = device

    def _helper(self, stem: str) -> str:
        _load_module(stem, self.device)
        return _MODULE_PREFIX + stem

    def visit_Import(self, node: ast.Import):
        out = []
        for alias in node.names:
            stem = _helper_stem(alias.name)
            if stem is not None:
                if alias.asname is None:  # the reference has none
                    raise NotImplementedError(
                        f"bare 'import {alias.name}' is not rewritten")
                out.append(ast.alias(self._helper(stem), alias.asname))
                continue
            new = _port_name(alias.name)
            if new != alias.name and alias.asname is None:
                # ``import sentinel_tpu[.x]`` binds ``sentinel_tpu``: bind
                # the port's top package under that name.
                if "." in alias.name:
                    out.append(ast.alias(new, None))
                out.append(ast.alias("sentinel_tpu_torch", "sentinel_tpu"))
                continue
            out.append(ast.alias(new, alias.asname))
        node.names = out
        return node

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.level == 0 and node.module:
            stem = _helper_stem(node.module)
            if stem is not None:
                node.module = self._helper(stem)
            else:
                node.module = _port_name(node.module)
        return node


def _compile(path: Path, device: str):
    source = path.read_bytes()
    tree = ast.parse(source, filename=str(path))
    tree = _ImportRewrite(device).visit(tree)
    ast.fix_missing_locations(tree)
    try:  # pytest's assertion messages, as the reference gets them
        from _pytest.assertion.rewrite import rewrite_asserts

        rewrite_asserts(tree, source, str(path), None)
    except Exception:  # noqa: BLE001 — plain asserts still check
        pass
    return compile(tree, str(path), "exec", dont_inherit=True)


def _load_module(stem: str, device: str) -> types.ModuleType:
    """The port-loaded module of ``tests/<stem>.py`` (one per process)."""
    key = (stem, device)
    mod = _LOADED.get(key)
    if mod is not None:
        return mod
    path = TESTS / f"{stem}.py"
    name = _MODULE_PREFIX + stem
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    _LOADED[key] = mod
    code = _compile(path, device)
    try:
        try:
            exec(code, mod.__dict__)
        except ModuleNotFoundError as ex:
            if (ex.name or "").split(".")[0] != "jax":
                raise
            # No JAX here (the card): the file's ``jax.numpy`` is the
            # port's stand-in; its cases run only as port variants.
            with _jax_stand_in(device):
                exec(code, mod.__dict__)
    except BaseException:
        del sys.modules[name]
        del _LOADED[key]
        raise
    return mod


class _jax_stand_in:
    """``jax`` / ``jax.numpy`` in ``sys.modules`` for one module load, as
    a :class:`PortArrays` stand-in."""

    def __init__(self, device: str):
        self.device = device

    def __enter__(self):
        jax = types.ModuleType("jax")
        jax.numpy = PortArrays(self.device)
        self._saved = {k: sys.modules.get(k) for k in ("jax", "jax.numpy")}
        sys.modules["jax"] = jax
        sys.modules["jax.numpy"] = jax.numpy

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


# ---------------------------------------------------------------------------
# exporting a file's tests under names that cannot collide
# ---------------------------------------------------------------------------


def ref_id(name: str, *path: str) -> str:
    """The reference's node id of a case: ``tests/<name>::A::b``."""
    return "::".join((f"tests/{name}",) + path)


def _fixture_parts(obj):
    """(function, marker) of a pytest fixture object, else None."""
    fn = getattr(obj, "_fixture_function", None)
    marker = getattr(obj, "_fixture_function_marker", None)
    if fn is None or marker is None:
        return None
    return fn, marker


def _renaming(fn, renames: dict):
    """``fn`` with the parameters named in ``renames`` renamed; the call
    maps them back. Marks and the generator kind carry over."""
    sig = inspect.signature(fn)
    names = [p.name for p in sig.parameters.values()]
    if not any(n in renames for n in names):
        return fn
    back = {renames[n]: n for n in names if n in renames}
    params = [p.replace(name=renames.get(p.name, p.name))
              for p in sig.parameters.values()]

    def _args(args, kwargs):
        return args, {back.get(k, k): v for k, v in kwargs.items()}

    if inspect.isgeneratorfunction(fn):
        def wrapper(*args, **kwargs):
            a, kw = _args(args, kwargs)
            return (yield from fn(*a, **kw))
    else:
        def wrapper(*args, **kwargs):
            a, kw = _args(args, kwargs)
            return fn(*a, **kw)
    wrapper.__signature__ = sig.replace(parameters=params)
    wrapper.__name__ = fn.__name__
    wrapper.__qualname__ = fn.__qualname__
    wrapper.__doc__ = fn.__doc__
    wrapper.__module__ = fn.__module__
    wrapper.__dict__.update(
        {k: v for k, v in fn.__dict__.items() if k != "__wrapped__"})
    return wrapper


def _marks_of(obj) -> list:
    """``obj.pytestmark`` as a list (pytest takes one mark or a list)."""
    m = getattr(obj, "pytestmark", None)
    if m is None:
        return []
    return list(m) if isinstance(m, (list, tuple)) else [m]


def _param_id(value, argnames) -> str:
    from _pytest.mark.structures import ParameterSet

    if isinstance(value, ParameterSet):
        if value.id is not None:
            return value.id
        value = value.values
    elif len(argnames) == 1:
        value = (value,)
    return "-".join(str(v) for v in value)


def _xfail_params(fn, rid: str, xfail: dict) -> None:
    """Strict xfail on single parametrized cases of ``fn`` (keys
    ``<rid>[<id>]``): the matching value of its one ``parametrize`` mark
    becomes a ``pytest.param`` carrying the mark."""
    keys = {k[len(rid) + 1:-1]: v for k, v in xfail.items()
            if k.startswith(rid + "[")}
    if not keys:
        return
    marks = _marks_of(fn)
    params = [m for m in marks if m.name == "parametrize"]
    assert len(params) == 1, f"{rid}: one parametrize mark expected"
    mark = params[0]
    argnames = mark.args[0]
    if isinstance(argnames, str):
        argnames = [a.strip() for a in argnames.split(",")]
    values, hit = [], set()
    for v in mark.args[1]:
        pid = _param_id(v, argnames)
        if pid in keys:
            from _pytest.mark.structures import ParameterSet

            vals = v.values if isinstance(v, ParameterSet) else (
                (v,) if len(argnames) == 1 else tuple(v))
            extra = list(v.marks) if isinstance(v, ParameterSet) else []
            v = pytest.param(*vals, id=pid, marks=extra + [
                pytest.mark.xfail(reason=keys[pid], strict=True)])
            hit.add(pid)
        values.append(v)
    assert hit == set(keys), f"{rid}: no parametrized case {set(keys) - hit}"
    new = pytest.mark.parametrize(mark.args[0], values, **mark.kwargs).mark
    fn.pytestmark = [new if m is mark else m for m in marks]


def _with_marks(obj, marks):
    for m in marks:
        obj = m(obj)
    return obj


def _class_copy(cls, name: str, renames: dict, marks, variants: dict,
                xfail: dict, ref_name: str, mod):
    """A subclass of ``cls`` holding the renamed wrappers, the variants
    and the xfail marks of its methods."""
    attrs = {"__module__": cls.__module__, "__qualname__": name}
    for attr in dir(cls):
        obj = getattr(cls, attr, None)
        parts = _fixture_parts(inspect.getattr_static(cls, attr, None))
        if parts is not None:
            fn, m = parts
            fix = _renaming(fn, renames)
            if fix is not fn:
                attrs[attr] = pytest.fixture(
                    scope=m.scope, params=m.params, autouse=m.autouse,
                    ids=m.ids, name=m.name)(fix)
            continue
        if not attr.startswith("test") or not callable(obj):
            continue
        rid = ref_id(ref_name, cls.__name__, attr)
        if rid in variants:
            attrs[attr] = _renaming(variants[rid](mod), renames)
            continue
        fn = _renaming(inspect.getattr_static(cls, attr), renames)
        if rid in xfail:
            fn = pytest.mark.xfail(reason=xfail[rid], strict=True)(fn)
        if fn is not inspect.getattr_static(cls, attr):
            attrs[attr] = fn
    new = type(name, (cls,), attrs)
    new.pytestmark = _marks_of(cls) + list(marks)
    return new


def load_reference(name: str, namespace: dict, device: str = DEVICE, *,
                   variants=None, xfail=None, excluded=None,
                   fixtures=None) -> dict:
    """Load ``tests/<name>`` against the port and export its cases into
    ``namespace`` (a group module's ``globals()``). ``variants`` maps a
    reference node id to the port variant that replaces the case,
    ``xfail`` to the caveat of a strict xfail, ``excluded`` to the reason
    it is left out, ``fixtures`` a fixture's id (``tests/<name>::<fixture>``)
    to ``factory(fixture function) -> replacement``. Returns
    ``{exported name: reference node id}``.

    A variant is given as ``factory(port-loaded module) -> test``."""
    variants = variants or {}
    xfail = xfail or {}
    excluded = excluded or {}
    fixtures = fixtures or {}
    stem = name[:-3]
    mod = _load_module(stem, device)
    namespace[f"port_{stem}"] = mod
    items = dict(vars(mod))

    # The file's own fixtures, renamed; autouse ones become marks.
    renames, autouse = {}, []
    for attr, obj in items.items():
        if _fixture_parts(obj) is not None:
            renames[obj.name] = f"{stem}__{attr}"
    for attr, obj in items.items():
        parts = _fixture_parts(obj)
        if parts is None:
            continue
        fn, m = parts
        if ref_id(name, attr) in fixtures:
            fn = fixtures[ref_id(name, attr)](fn)
        new = f"{stem}__{attr}"
        namespace[new] = pytest.fixture(
            scope=m.scope, params=m.params, autouse=False, ids=m.ids,
            name=new)(_renaming(fn, renames))
        if m.autouse:
            autouse.append(new)

    marks = _marks_of(mod)
    if autouse:
        marks = [pytest.mark.usefixtures(*autouse)] + marks

    exported = {}
    for attr, obj in items.items():
        if attr.startswith("test") and inspect.isfunction(obj) \
                and getattr(obj, "__test__", True):
            rid = ref_id(name, attr)
            if rid in excluded:
                continue
            if rid in variants:
                fn = _renaming(variants[rid](mod), renames)
            else:
                fn = _renaming(obj, renames)
                if rid in xfail:
                    fn = pytest.mark.xfail(reason=xfail[rid],
                                           strict=True)(fn)
            if fn is obj:
                # Marks go on a copy: the port-loaded function object is
                # shared with any file that imports it.
                fn = rebind(obj)
            _xfail_params(fn, rid, xfail)
            new = f"{stem}__{attr}"
            namespace[new] = _with_marks(fn, marks)
            exported[new] = rid
        elif attr.startswith("Test") and inspect.isclass(obj) \
                and getattr(obj, "__test__", True) \
                and obj.__module__ == mod.__name__:
            rid = ref_id(name, attr)
            if rid in excluded:
                continue
            new = f"Test__{stem}__{attr}"
            namespace[new] = _class_copy(obj, new, renames, marks,
                                         variants, xfail, name, mod)
            exported[new] = rid
    return exported


# ---------------------------------------------------------------------------
# port variants: the reference's body with its JAX-only names replaced
# ---------------------------------------------------------------------------


def rebind(fn, **names):
    """``fn`` (a port-loaded reference function) with the module globals
    in ``names`` replaced for its own body only; marks and signature are
    kept. The variant's body, and so every assertion, is the
    reference's."""
    glb = dict(fn.__globals__)
    glb.update(names)
    new = types.FunctionType(fn.__code__, glb, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__dict__.update(fn.__dict__)
    new.__qualname__ = fn.__qualname__
    return new


def step_alias(fn):
    """Port variant of a case that reads or replaces the JAX engine's
    jitted steps: the body as written, with ``engine._entry_jit`` /
    ``_exit_jit`` read and assigned as the port's ``_entry_step`` /
    ``_exit_step`` (the functions every dispatch calls)."""
    from sentinel_tpu_torch.core.engine import SentinelEngine

    def alias(name):
        return property(lambda self: getattr(self, name),
                        lambda self, v: setattr(self, name, v))

    def variant(*args, **kwargs):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(SentinelEngine, "_entry_jit", alias("_entry_step"),
                       raising=False)
            mp.setattr(SentinelEngine, "_exit_jit", alias("_exit_step"),
                       raising=False)
            return fn(*args, **kwargs)

    variant.__signature__ = inspect.signature(fn)
    variant.__name__ = fn.__name__
    variant.__doc__ = fn.__doc__
    variant.__dict__.update(fn.__dict__)
    return variant


class _DType:
    """A ``jnp`` dtype stand-in: the torch dtype, and as a callable the
    host scalar the port's ops take (``jnp.int64(now)`` -> ``int``)."""

    def __init__(self, torch_dtype, scalar):
        self.torch = torch_dtype
        self._scalar = scalar

    def __call__(self, x):
        return self._scalar(x)


class PortArrays:
    """Stand-in for ``jax.numpy`` in a port variant: arrays become tensors
    on the harness's device (``asarray`` / ``array``), scalars host
    numbers, dtypes the matching torch dtypes."""

    int32 = _DType(torch.int32, int)
    int64 = _DType(torch.int64, int)
    float32 = _DType(torch.float32, float)
    bool_ = _DType(torch.bool, bool)

    def __init__(self, device: str):
        self.device = device

    def asarray(self, x, dtype=None):
        import numpy as np

        if not isinstance(x, torch.Tensor) and np.ndim(x) == 0:
            # A clock or a count: the port's ops take host scalars.
            return dtype(x) if dtype is not None else x
        if isinstance(x, torch.Tensor):
            t = x
        else:
            a = np.asarray(x)
            if a.dtype == np.uint32:
                a = a.astype(np.int64)
            t = torch.from_numpy(np.array(a, order="C"))
        if dtype is not None:
            t = t.to(dtype.torch)
        return t.to(self.device)

    array = asarray


class PortJax:
    """Stand-in for ``jax`` in a port variant: the port's steps run
    eagerly, so ``jit`` is the function itself and ``block_until_ready``
    waits for the card."""

    def __init__(self, device: str):
        self.numpy = PortArrays(device)

    @staticmethod
    def jit(fn, **_kw):
        return fn

    @staticmethod
    def block_until_ready(x):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return x


def jax_stand_in(fn, device: str = DEVICE):
    """Port variant of a case that imports JAX in its own body: the body
    as written, its ``import jax`` / ``import jax.numpy`` (and the
    module's ``jax`` / ``jnp``) resolving to :class:`PortJax` /
    :class:`PortArrays`, for that function's frame only."""
    import builtins

    jax = PortJax(device)
    real = builtins.__import__

    def _import(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and (name == "jax" or name.startswith("jax.")):
            return jax.numpy if name == "jax.numpy" and fromlist else jax
        return real(name, globals, locals, fromlist, level)

    names = dict(vars(builtins))
    names["__import__"] = _import
    return rebind(fn, __builtins__=names, jax=jax, jnp=jax.numpy)


# ---------------------------------------------------------------------------
# the harness: port fixtures on an explicit device
# ---------------------------------------------------------------------------


_TENSOR_ARRAY = torch.Tensor.__array__


def _host_array(self, *args, **kwargs):
    if self.device.type != "cpu":
        self = self.detach().cpu()
    return _TENSOR_ARRAY(self, *args, **kwargs)


def _harness(device: str) -> dict:
    from sentinel_tpu_torch.core import context as ctx
    from sentinel_tpu_torch.utils import device as device_mod
    from sentinel_tpu_torch.utils import time_util

    original = device_mod.resolve_device

    def resolve_device(dev=None):
        return original(device if dev is None else dev)

    @pytest.fixture(scope="module", autouse=True)
    def _refsuite_device():
        """A case (or a module-scoped fixture) that builds an engine or a
        service with no device gets the harness's device, for the length
        of the group module."""
        with pytest.MonkeyPatch.context() as mp:
            if torch.device(device).type != "cpu":
                # The reference reads device arrays with ``np.asarray``
                # (JAX copies them to the host); a card tensor reads the
                # same way here.
                mp.setattr(torch.Tensor, "__array__", _host_array)
            mp.setattr(device_mod, "resolve_device", resolve_device)
            for mname, m in list(sys.modules.items()):
                if mname.startswith("sentinel_tpu_torch") and m is not None \
                        and getattr(m, "resolve_device", None) is original:
                    mp.setattr(m, "resolve_device", resolve_device)
            yield

    @pytest.fixture()
    def frozen_time():
        """Pin the port's clock to a deterministic epoch."""
        time_util.freeze_time(1_700_000_000_000)
        yield time_util
        time_util.unfreeze_time()

    @pytest.fixture()
    def engine(frozen_time):
        """Fresh default port engine on the harness's device, pinned
        clock, clean context."""
        ctx.replace_context(None)
        ctx.bump_generation()
        eng = sentinel_tpu_torch.reset(capacity=512, device=device)
        yield eng
        ctx.replace_context(None)
        sentinel_tpu_torch.reset(capacity=512, device=device)

    return {"_refsuite_device": _refsuite_device,
            "frozen_time": frozen_time, "engine": engine}


def install(namespace: dict, files, *, variants=None, xfail=None,
            excluded=None, fixtures=None, device: str = DEVICE) -> dict:
    """The harness fixtures and every file of a group into ``namespace``.
    Returns ``{exported name: reference node id}`` over the group."""
    namespace.update(_harness(device))
    exported = {}
    for name in files:
        exported.update(load_reference(name, namespace, device,
                                       variants=variants, xfail=xfail,
                                       excluded=excluded, fixtures=fixtures))
    return exported


# ---------------------------------------------------------------------------
# the accounting
# ---------------------------------------------------------------------------


def _collect(paths) -> list:
    """Node ids that pytest collects from ``paths`` (a child process, on
    the CPU: the reference files import JAX)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("SENTINEL_REFSUITE_DEVICE", None)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
         *paths],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    ids = [ln.strip() for ln in out.stdout.splitlines()
           if "::" in ln and not ln.startswith(("ERROR", "FAILED"))]
    assert ids, out.stdout[-2000:] + out.stderr[-2000:]
    return ids


def _source_ids(name: str) -> set:
    """The cases of a reference file that does not collect (C2), by the
    test functions and classes its source defines."""
    tree = ast.parse((TESTS / name).read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            out.add(ref_id(name, node.name))
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            out.add(ref_id(name, node.name))
    return out


def port_to_ref(group: str, node_id: str, exported: dict):
    """A group module's node id -> the reference's node id, or None for
    a case of the group's own."""
    prefix = f"tests/{group}::"
    if not node_id.startswith(prefix):
        return None
    rest = node_id[len(prefix):]
    head, sep, tail = rest.partition("::")
    bracket = ""
    if not sep and "[" in head:
        head, _, b = head.partition("[")
        bracket = "[" + b
    rid = exported.get(head)
    if rid is None:
        return None
    return rid + (sep + tail if sep else "") + bracket


def check_accounting(group_file: str, files, exported: dict, variants: dict,
                     xfail: dict, excluded: dict) -> dict:
    """Every case the reference files collect is exactly one of: run as
    written (a), port variant (b), strict xfail (c), excluded with a
    reason (d). ``files`` are every reference file the group answers for,
    a wholly excluded one too. Returns ``{file: {kind: count}}``."""
    group = Path(group_file).name
    ids = _collect([f"tests/{f}" for f in files] + [f"tests/{group}"])
    ref = {i for i in ids if not i.startswith(f"tests/{group}::")}
    for f in files:
        if not any(i.startswith(f"tests/{f}::") for i in ref):
            ref |= _source_ids(f)
    port = {}
    for i in ids:
        r = port_to_ref(group, i, exported)
        if r is not None:
            port[r] = i

    def base(i):
        return i.split("[")[0]

    def listed(i, table):
        parts = base(i).split("::")
        return i in table or any("::".join(parts[:k]) in table
                                 for k in range(1, len(parts) + 1))

    excl = {i for i in ref if listed(i, excluded)}
    assert not excl & set(port), sorted(excl & set(port))
    assert set(port) | excl == ref, (
        "reference cases neither run nor listed: "
        f"{sorted(ref - set(port) - excl)}; "
        f"port cases with no reference: {sorted(set(port) - ref)}")
    for table, what in ((variants, "variant"), (xfail, "xfail"),
                        (excluded, "exclusion")):
        for key in table:
            assert any(listed(i, {key}) for i in ref), \
                f"{what} for no reference case: {key}"
    counts = {}
    for i in sorted(ref):
        f = i.split("::")[0][len("tests/"):]
        c = counts.setdefault(f, {"a": 0, "b": 0, "c": 0, "d": 0})
        kind = ("d" if i in excl else "b" if listed(i, variants)
                else "c" if listed(i, xfail) else "a")
        c[kind] += 1
    return counts


# ---------------------------------------------------------------------------
# tests of the loader itself
# ---------------------------------------------------------------------------


def test_import_rewrite_touches_only_the_two_kinds():
    src = ("import sentinel_tpu as st\n"
           "import sentinel_tpu.ops.segment as seg\n"
           "from sentinel_tpu.core import constants as C\n"
           "import numpy as np\n"
           "from tests.oracle import OracleLeapArray\n")
    tree = _ImportRewrite(DEVICE).visit(ast.parse(src))
    out = ast.unparse(tree)
    assert "import sentinel_tpu_torch as st" in out
    assert "import sentinel_tpu_torch.ops.segment as seg" in out
    assert "from sentinel_tpu_torch.core import constants as C" in out
    assert "import numpy as np" in out
    assert "from tests.oracle import OracleLeapArray" in out


def test_bare_package_import_binds_the_port_under_the_old_name():
    tree = _ImportRewrite(DEVICE).visit(
        ast.parse("import sentinel_tpu.telemetry.fleet\nimport sentinel_tpu\n"))
    ns: dict = {}
    exec(compile(ast.fix_missing_locations(tree), "<t>", "exec"), ns)
    assert ns["sentinel_tpu"] is sentinel_tpu_torch


def test_helper_import_names_the_port_loaded_module():
    tree = _ImportRewrite(DEVICE).visit(
        ast.parse("from tests.test_telemetry import _batch\n"))
    assert ast.unparse(tree) == \
        f"from {_MODULE_PREFIX}test_telemetry import _batch"
    mod = sys.modules[_MODULE_PREFIX + "test_telemetry"]
    assert mod.st is sentinel_tpu_torch
    assert "sentinel_tpu_torch" in mod._batch.__globals__["EntryBatch"] \
        .__module__


def test_tracebacks_point_at_the_reference_file():
    mod = _load_module("test_flow", DEVICE)
    fn = mod.test_flow_qps_demo_golden
    assert fn.__code__.co_filename == str(TESTS / "test_flow.py")
    src = (TESTS / "test_flow.py").read_text().splitlines()
    assert "def test_flow_qps_demo_golden" in src[fn.__code__.co_firstlineno
                                                  - 1]


def test_loader_and_port_import_no_jax():
    """This file and the port load in a process that has no JAX."""
    code = ("import sys\n"
            "class _Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name == 'jax' or name.startswith(('jax.', 'jaxlib',\n"
            "                'sentinel_tpu.')) or name == 'sentinel_tpu':\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, _Block())\n"
            "import tests.test_torch_refsuite as r\n"
            "r._load_module('test_flow', 'cpu')\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_device_policy_is_unchanged():
    """The harness names its device; the package still has no CPU
    default outside the harness's module-scoped patch."""
    from sentinel_tpu_torch.utils.device import resolve_device

    assert torch.device(DEVICE).type in ("cpu", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
