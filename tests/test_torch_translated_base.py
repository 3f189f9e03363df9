"""The JAX package's ``tests/gpflow_tpu/test_base.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; a Module subclass calls ``super().__init__()``, as an ``nn.Module``
must; ``np.dtype`` of a dtype is ``as_torch_dtype``; ``parameters`` is the
port's ``all_parameters`` (ROADMAP Queue 3); a pytree round trip of a Module
goes through the support module's ``tree_flatten`` and ``tree_unflatten``
(``functionalize``'s flat values and a module rebuilt from them), and
``jax.grad`` with respect to a Module through ``functionalize`` with
autograd.

Tests for the Parameter/Module pytree core (mirrors reference
``tests/gpflow/test_base.py`` coverage).
"""
import numpy as np
import pytest
import torch

import gpflow_tpu_torch
from gpflow_tpu_torch import Parameter, PriorOn, priors
from gpflow_tpu_torch.base import Module
from gpflow_tpu_torch.bijectors import Exp, Identity, Softplus, positive, triangular
from gpflow_tpu_torch.config import as_torch_dtype
from .test_torch_translated_support import X64, asarray, deviation, grad, jit, translated_test_environment, tree_flatten, tree_leaves, tree_map, tree_unflatten  # noqa: F401


def test_parameter_constrained_roundtrip():
    p = Parameter(1.5, transform=positive())
    np.testing.assert_allclose(p.numpy(), 1.5, rtol=1e-12)
    p.assign(0.25)
    np.testing.assert_allclose(p.numpy(), 0.25, rtol=1e-12)


def test_parameter_rejects_nonfinite():
    p = Parameter(1.0, transform=positive())
    with pytest.raises(ValueError):
        p.assign(np.nan)
    with pytest.raises(ValueError):
        Parameter(np.inf)


def test_parameter_default_dtype_is_default_float():
    p = Parameter(1.0)
    assert p.dtype == as_torch_dtype(gpflow_tpu_torch.default_float())
    p_int_input = Parameter(2)
    assert p_int_input.dtype == as_torch_dtype(gpflow_tpu_torch.default_float())


def test_parameter_scalar_respects_float32_config():
    # weakly-typed Python scalars/lists must take default_float(), not the
    # np-promoted float64 (wrong host precision under f32 config)
    from gpflow_tpu_torch import config

    config.set_default_float(np.float32)
    try:
        assert Parameter(0.5).dtype == as_torch_dtype(np.float32)
        assert Parameter([0.5, 1.5]).dtype == as_torch_dtype(np.float32)
        # arrays carrying an explicit float dtype keep it
        assert Parameter(np.float64(0.5)).dtype == as_torch_dtype(np.float64)
        assert Parameter(np.ones(2, np.float64)).dtype == as_torch_dtype(np.float64)
    finally:
        config.set_default_float(np.float64)


@deviation("the output side of F3")
def test_parameter_scalar_stays_on_host_path():
    # 0-d bijector results are np scalars; they must stay on the host
    # (NumPy) path, not fall back to eager device ops
    p = Parameter(0.5, transform=Softplus())
    assert isinstance(p.value, (np.ndarray, np.generic))
    assert isinstance(p.numpy(), (np.ndarray, np.generic))
    p.assign(0.25)
    assert isinstance(p.value, (np.ndarray, np.generic))
    np.testing.assert_allclose(p.numpy(), 0.25, rtol=1e-12)


def test_parameter_arithmetic_acts_like_array():
    p = Parameter([1.0, 2.0])
    np.testing.assert_allclose(p + 1.0, [2.0, 3.0])
    np.testing.assert_allclose(2.0 * p, [2.0, 4.0])
    np.testing.assert_allclose(torch.sum(asarray(p)), 3.0)
    np.testing.assert_allclose((-p), [-1.0, -2.0])
    np.testing.assert_allclose(p[1], 2.0)


def test_parameter_pytree_roundtrip():
    p = Parameter(3.0, transform=positive(), trainable=False, name="x")
    leaves, treedef = tree_flatten(p)
    p2 = tree_unflatten(treedef, leaves)
    assert p2.name == "x"
    assert not p2.trainable
    np.testing.assert_allclose(p2.numpy(), 3.0, rtol=1e-12)


def test_log_prior_density_constrained():
    prior = priors.Gamma(2.0, 2.0)
    p = Parameter(1.3, transform=positive(), prior=prior)
    expected = 2.0 * np.log(2.0) + np.log(1.3) - 2.0 * 1.3 - 0.0  # log Gamma(2, rate 2) pdf
    from scipy import stats

    expected = stats.gamma.logpdf(1.3, a=2.0, scale=0.5)
    np.testing.assert_allclose(p.log_prior_density(), expected, rtol=1e-10)


def test_log_prior_density_unconstrained_jacobian():
    # For prior on unconstrained with exp transform: log p(x) - log|dy/dx| at x
    prior = priors.Normal(0.0, 1.0)
    p = Parameter(2.0, transform=Exp(), prior=prior, prior_on=PriorOn.UNCONSTRAINED)
    x = np.log(2.0)
    from scipy import stats

    expected = stats.norm.logpdf(x) - x  # forward ldj of exp at x is x
    np.testing.assert_allclose(p.log_prior_density(), expected, rtol=1e-10)


class _Inner(Module):
    def __init__(self):
        super().__init__()
        self.a = Parameter(1.0, transform=positive())
        self.flag = True


class _Outer(Module):
    def __init__(self):
        super().__init__()
        self.inner = _Inner()
        self.b = Parameter([1.0, 2.0], trainable=False)
        self.data = torch.arange(3.0, **X64)
        self.n = 7


def test_module_parameters_and_trainability():
    m = _Outer()
    assert len(m.all_parameters) == 2
    assert len(m.trainable_parameters) == 1
    gpflow_tpu_torch.set_trainable(m, False)
    assert len(m.trainable_parameters) == 0


def test_module_pytree_static_preserved():
    m = _Outer()
    leaves, treedef = tree_flatten(m)
    m2 = tree_unflatten(treedef, leaves)
    assert m2.n == 7 and m2.inner.flag is True


def test_module_jit_and_grad():
    m = _Outer()

    def loss(mod):
        return mod.inner.a.value ** 2 + torch.sum(mod.b.value) + torch.sum(mod.data)

    jitted = jit(loss)
    np.testing.assert_allclose(jitted(m), loss(m), rtol=1e-12)
    g = grad(loss)(m)
    assert isinstance(g, _Outer)


@deviation("eager")
def test_module_jit_cache_stable():
    m = _Outer()
    traces = []

    @jit
    def loss(mod):
        traces.append(1)
        return mod.inner.a.value

    loss(m)
    m.inner.a.assign(5.0)
    loss(m)
    assert len(traces) == 1, "mutating a parameter value must not retrace"


def test_utilities_traversal():
    m = _Outer()
    pd = gpflow_tpu_torch.utilities.parameter_dict(m)
    assert set(pd) == {".inner.a", ".b"}
    gpflow_tpu_torch.utilities.multiple_assign(m, {".inner.a": 9.0})
    np.testing.assert_allclose(m.inner.a.numpy(), 9.0, rtol=1e-10)
    values = gpflow_tpu_torch.utilities.read_values(m)
    np.testing.assert_allclose(values[".inner.a"], 9.0, rtol=1e-10)
    # summary renders
    s = gpflow_tpu_torch.utilities.tabulate_module_summary(m)
    assert "inner.a" in s.replace(" ", "") or "inner.a" in s


def test_freeze_and_deepcopy():
    m = _Outer()
    frozen = gpflow_tpu_torch.utilities.freeze(m)
    assert len(frozen.trainable_parameters) == 0
    assert len(m.trainable_parameters) == 1  # original untouched
    m_copy = gpflow_tpu_torch.utilities.deepcopy(m)
    m_copy.inner.a.assign(123.0)
    np.testing.assert_allclose(m.inner.a.numpy(), 1.0, rtol=1e-10)


def test_triangular_bijector_mask():
    tb = triangular()  # TriangularMask: full-matrix storage, tril select
    x = torch.arange(1.0, 10.0, **X64).reshape(3, 3)
    L = tb.forward(x)
    np.testing.assert_allclose(np.triu(np.asarray(L), 1), 0.0)
    np.testing.assert_allclose(np.tril(np.asarray(L)), np.tril(np.asarray(x)))
    np.testing.assert_allclose(tb.inverse(L), np.asarray(L))


def test_fill_triangular_bijector_roundtrip():
    from gpflow_tpu_torch.bijectors import FillTriangular

    tb = FillTriangular()
    v = torch.arange(1.0, 7.0, **X64)
    L = tb.forward(v)
    assert L.shape == (3, 3)
    np.testing.assert_allclose(np.triu(np.asarray(L), 1), 0.0)
    np.testing.assert_allclose(tb.inverse(L), v)


def test_capture_parameter_reads():
    from gpflow_tpu_torch.base import capture_parameter_reads

    a = Parameter(1.0, name="a")
    b = Parameter([2.0, 3.0], transform=positive(), name="b")
    c = Parameter(4.0, name="c")

    with capture_parameter_reads() as cap:
        _ = a.value + torch.sum(asarray(b))
        _ = a.value  # duplicate read: recorded once
    names = [p.name for p in cap.parameters]
    assert names == ["a", "b"]  # first-read order, deduplicated; c unread

    # capture must not leak outside the block
    _ = c.value
    assert [p.name for p in cap.parameters] == ["a", "b"]


def test_capture_parameter_reads_nested():
    from gpflow_tpu_torch.base import capture_parameter_reads

    a = Parameter(1.0, name="a")
    b = Parameter(2.0, name="b")
    with capture_parameter_reads() as outer:
        _ = a.value
        with capture_parameter_reads() as inner:
            _ = b.value
        _ = a.value
    assert [p.name for p in inner.parameters] == ["b"]
    assert [p.name for p in outer.parameters] == ["a"]  # inner reads go inner


def test_parameter_copy_construction_inherits_metadata():
    """Parameter(Parameter) inherits transform/prior/prior_on/trainable/name
    unless overridden (reference base.py:155-166)."""
    from gpflow_tpu_torch import priors
    from gpflow_tpu_torch.utilities import positive

    src = Parameter(
        2.0, transform=positive(), prior=priors.Gamma(2.0, 3.0),
        prior_on="unconstrained", trainable=False, name="src",
    )
    cp = Parameter(src)
    assert cp.transform is src.transform
    assert cp.prior is src.prior
    assert cp.prior_on == src.prior_on
    assert cp.trainable is False
    assert cp.name == "src"
    np.testing.assert_allclose(np.asarray(cp.value), 2.0)

    # overrides win
    cp2 = Parameter(src, trainable=True, name="other")
    assert cp2.trainable is True
    assert cp2.name == "other"


def test_parameter_value_and_unconstrained_value_exclusive():
    # passing both would silently ignore `value` — must be an error
    with pytest.raises(ValueError, match="not both"):
        Parameter(1.0, unconstrained_value=0.5)
    # unconstrained_value alone works and is validated for finiteness
    p = Parameter(None, transform=Exp(), unconstrained_value=0.0)
    np.testing.assert_allclose(p.numpy(), 1.0, rtol=1e-12)
    with pytest.raises(ValueError, match="NaN or Inf"):
        Parameter(None, unconstrained_value=np.nan)


def test_parameter_shape_is_not_a_read_and_is_cached():
    from gpflow_tpu_torch.base import capture_parameter_reads
    from gpflow_tpu_torch.bijectors import FillTriangular

    p = Parameter(np.tril(np.ones((3, 3))) + np.eye(3), transform=FillTriangular())
    assert p.shape == (3, 3)  # constrained shape, not the packed (6,)
    assert p.ndim == 2
    with capture_parameter_reads() as cap:
        _ = p.shape
        _ = p.ndim
    assert cap.parameters == [], "shape inspection must not count as a read"
    # cache stays consistent across unconstrained-shape-preserving assigns
    p.assign(np.tril(2.0 * np.ones((3, 3))) + np.eye(3))
    assert p.shape == (3, 3)


@deviation("parameter equality")
def test_parameter_eq_elementwise():
    p = Parameter([1.0, 2.0])
    q = Parameter([1.0, 3.0])
    np.testing.assert_array_equal(np.asarray(p == q), [True, False])
    np.testing.assert_array_equal(np.asarray(p != q), [False, True])
    np.testing.assert_array_equal(np.asarray(p == np.array([1.0, 0.0])), [True, False])
    assert (p == p) is True and (p != p) is False  # identity fast path
    # identity hash retained: Parameters remain usable as set/dict members
    assert len({p, q}) == 2


class _MixedContainers(Module):
    def __init__(self):
        super().__init__()
        self.items = [Parameter(1.0, name="p0"), "label", 3]
        self.table = {"p": Parameter(2.0, name="p1"), "mode": "fast"}
        self.cfg = {"depth": 2}  # fully-static dict attribute
        self.pair = (Parameter(4.0, name="p2"), None, "x")


def test_module_mixed_containers_roundtrip():
    m = _MixedContainers()
    leaves, treedef = tree_flatten(m)
    m2 = tree_unflatten(treedef, leaves)
    # static elements inside dynamic containers survive with original types
    assert m2.items[1] == "label" and m2.items[2] == 3
    assert isinstance(m2.table, dict) and m2.table["mode"] == "fast"
    assert isinstance(m2.cfg, dict) and m2.cfg["depth"] == 2
    assert m2.pair[1] is None and m2.pair[2] == "x"
    np.testing.assert_allclose(np.asarray(m2.items[0].value), 1.0)
    np.testing.assert_allclose(np.asarray(m2.table["p"].value), 2.0)
    np.testing.assert_allclose(np.asarray(m2.pair[0].value), 4.0)
    assert len(m.all_parameters) == 3


@deviation("eager")
def test_module_mixed_dict_treedef_stable_and_tree_mappable():
    """Insertion order != sorted order must not destabilize the treedef:
    tree_map over (model, grads) — the standard optimizer-update pattern —
    and re-jitting a reconstructed module must both work (the spec once
    recorded insertion order while JAX unflattens dicts sorted)."""

    class _M(Module):
        def __init__(self):
            super().__init__()
            self.table = {"p": Parameter(2.0), "mode": "fast"}  # p > mode

    m = _M()
    leaves, td = tree_flatten(m)
    m2 = tree_unflatten(td, leaves)
    _, td2 = tree_flatten(m2)
    assert td == td2, "flatten(unflatten(m)) must reproduce the treedef"

    g = grad(lambda mod: mod.table["p"].value ** 2)(m)
    summed = tree_map(lambda a, b: a + b, m, g)
    assert isinstance(summed, _M)

    traces = []

    @jit
    def loss(mod):
        traces.append(1)
        return mod.table["p"].value

    loss(m)
    loss(m2)  # reconstructed module: same treedef -> no retrace
    assert len(traces) == 1


def test_module_container_subclasses_preserved():
    """OrderedDict order/type and defaultdict factory survive the module
    round trip (JAX itself preserves them; the static-split machinery must
    not degrade them to plain containers)."""
    from collections import OrderedDict, defaultdict

    class _M(Module):
        def __init__(self):
            super().__init__()
            self.od = OrderedDict([("b", Parameter(1.0)), ("a", Parameter(2.0))])
            self.dd = defaultdict(int, {"y": Parameter(3.0), "x": Parameter(4.0)})
            # mixed variants: static element inside each subclass type
            self.od_mixed = OrderedDict([("z", Parameter(5.0)), ("tag", "s")])
            self.dd_mixed = defaultdict(list, {"w": Parameter(6.0), "mode": "m"})

    m = _M()
    leaves, td = tree_flatten(m)
    m2 = tree_unflatten(td, leaves)
    assert type(m2.od) is OrderedDict and list(m2.od) == ["b", "a"]
    assert type(m2.dd) is defaultdict and m2.dd.default_factory is int
    assert type(m2.od_mixed) is OrderedDict and m2.od_mixed["tag"] == "s"
    assert list(m2.od_mixed) == ["z", "tag"]
    assert type(m2.dd_mixed) is defaultdict and m2.dd_mixed.default_factory is list
    assert m2.dd_mixed["mode"] == "m"
    np.testing.assert_allclose(np.asarray(m2.od["b"].value), 1.0)
    np.testing.assert_allclose(np.asarray(m2.dd_mixed["w"].value), 6.0)
    _, td2 = tree_flatten(m2)
    assert td == td2


@deviation("eager")
def test_module_mixed_containers_jit_and_grad():
    m = _MixedContainers()
    traces = []

    @jit
    def loss(mod):
        traces.append(1)
        # statics must come back usable inside the traced function
        assert mod.table["mode"] == "fast" and mod.cfg["depth"] == 2
        return (
            mod.items[0].value ** 2
            + mod.table["p"].value
            + mod.pair[0].value * mod.items[2]
        )

    np.testing.assert_allclose(float(loss(m)), 1.0 + 2.0 + 12.0, rtol=1e-12)
    m.items[0].assign(3.0)
    np.testing.assert_allclose(float(loss(m)), 9.0 + 2.0 + 12.0, rtol=1e-12)
    assert len(traces) == 1, "value change must not retrace"
    m.table["mode"] = "slow"  # static change -> retrace (cache keyed on aux)
    with pytest.raises(AssertionError):
        loss(m)
    g = grad(lambda mod: mod.items[0].value ** 2)(m)
    assert isinstance(g, _MixedContainers)


@deviation("eager")
@pytest.mark.parametrize("seed", range(10))
def test_module_random_structure_roundtrip_fuzz(seed):
    """Random nested attribute structures (Parameters/arrays mixed with
    strings/ints/None at every level) must round-trip through
    flatten/unflatten exactly and jit without retracing on value change."""
    r = np.random.RandomState(seed)

    def rand_value(depth):
        kinds = ["param", "np", "float", "str", "int", "none"]
        if depth < 2:
            kinds += ["list", "tuple", "dict"] * 2
        k = kinds[r.randint(len(kinds))]
        if k == "param":
            return Parameter(r.rand(2) + 0.5, name=f"p{r.randint(1000)}")
        if k == "np":
            return r.rand(3)
        if k == "float":
            return float(r.rand())
        if k == "str":
            return f"s{r.randint(10)}"
        if k == "int":
            return int(r.randint(100))
        if k == "none":
            return None
        n = r.randint(1, 4)
        if k == "list":
            return [rand_value(depth + 1) for _ in range(n)]
        if k == "tuple":
            return tuple(rand_value(depth + 1) for _ in range(n))
        # dict keys inserted in SHUFFLED order (insertion != sorted is the
        # case the spec machinery must keep treedef-stable); sometimes an
        # OrderedDict, which JAX flattens by insertion order instead
        keys = [f"k{i}" for i in range(n)]
        r.shuffle(keys)
        items = [(key, rand_value(depth + 1)) for key in keys]
        if r.randint(4) == 0:
            from collections import OrderedDict

            return OrderedDict(items)
        return dict(items)

    class _Fuzz(Module):
        def __init__(self):
            super().__init__()
            for i in range(r.randint(2, 6)):
                setattr(self, f"attr{i}", rand_value(0))

    m = _Fuzz()
    leaves, treedef = tree_flatten(m)
    m2 = tree_unflatten(treedef, leaves)
    _, treedef2 = tree_flatten(m2)
    assert treedef == treedef2, "round trip must not destabilize the treedef"

    def structure(v):
        if isinstance(v, Parameter):
            return ("P", np.asarray(v.value).tolist())
        if isinstance(v, (np.ndarray, torch.Tensor)):
            return ("A", np.asarray(v).tolist())
        if isinstance(v, list):
            return ("L", [structure(e) for e in v])
        if isinstance(v, tuple):
            return ("T", [structure(e) for e in v])
        if isinstance(v, dict):
            return ("D", sorted((k, structure(e)) for k, e in v.items()))
        return ("S", v)

    for k in vars(m):
        assert structure(getattr(m, k)) == structure(getattr(m2, k)), k

    traces = []

    @jit
    def total(mod):
        traces.append(1)
        leaves = tree_leaves(
            mod, is_leaf=lambda x: isinstance(x, Parameter)
        )
        vals = [
            torch.sum(l.value if isinstance(l, Parameter) else asarray(l))
            for l in leaves
        ]
        return sum(vals) if vals else torch.zeros((), **X64)

    v1 = float(total(m))
    assert np.isfinite(v1)
    for p in m.all_parameters:
        p.assign(np.asarray(p.value) + 1.0)
    total(m)
    assert len(traces) == 1, "parameter value change must not retrace"


def test_parameter_declared_shape_validation():
    from gpflow_tpu_torch.utilities import positive

    p = Parameter(np.ones((3, 2)), shape=(3, 2))
    assert p.shape == (3, 2)
    p = Parameter(np.ones((3, 2)), shape=(None, 2))  # None matches any dim
    assert p.shape == (3, 2)
    with pytest.raises(ValueError, match="declared"):
        Parameter(np.ones((3, 2)), shape=(4, 2))
    with pytest.raises(ValueError, match="declared"):
        Parameter(np.ones(3), shape=(3, 1))  # rank mismatch
    with pytest.raises(AssertionError):
        Parameter(np.ones(3), shape=(3,), unconstrained_shape=(3,))
    # separate constrained/unconstrained declarations
    p = Parameter(
        2.0, transform=positive(), unconstrained_shape=(), constrained_shape=()
    )
    assert p.shape == ()
    with pytest.raises(ValueError, match="constrained"):
        Parameter(2.0, transform=positive(), constrained_shape=(1,))
