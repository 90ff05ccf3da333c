"""The port's shape contracts (``hfrep_tpu_torch/analysis/contracts.py``)
against the JAX package's (``hfrep_tpu/analysis/contracts.py``).

- the JAX package's seven ``@contract`` specs parse the same under both
  parsers;
- the JAX package's runtime and static grammar cases
  (``tests/test_analysis.py::TestRuntimeContract`` / ``TestShapeContracts``)
  get the same verdict and message from both;
- each decorated pair on the same numpy-seeded inputs: the same output at
  its module's bars (``tests/test_torch_replication.py``,
  ``test_torch_data.py``, ``test_torch_metrics.py``,
  ``test_torch_flops.py``) and a ``ContractError`` on the same bad shapes,
  with the same message where the two specs are the same text;
- the port's lane-batched ``...`` call against JAX's ``jax.vmap`` of the
  per-lane function;
- ``HFREP_CONTRACTS=0`` turns the check off in both.
"""

from __future__ import annotations

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.analysis import analyze_source as jax_analyze_source
from hfrep_tpu.analysis import contracts as jax_contracts
from hfrep_tpu.analysis.rules import RULES_BY_ID as JAX_RULES
from hfrep_tpu.core import sampling as jax_sampling
from hfrep_tpu.obs import flops as jax_flops
from hfrep_tpu.ops import rolling as jax_rolling
from hfrep_tpu.ops import sqrtm as jax_sqrtm
from hfrep_tpu_torch.analysis import analyze_source
from hfrep_tpu_torch.analysis import contracts
from hfrep_tpu_torch.analysis.rules import RULES_BY_ID
from hfrep_tpu_torch.core import sampling
from hfrep_tpu_torch.obs import flops
from hfrep_tpu_torch.ops import rolling, sqrtm

#: (JAX function, port function, the port's spec): the spec is JAX's but
#: where the port batches lanes (``...``) or takes no PRNG key
PAIRS = {
    "_window_stack": (jax_rolling._window_stack, rolling._window_stack,
                      "(...,T,F)->(...,N,W,F)"),
    "rolling_ols_beta": (jax_rolling.rolling_ols_beta, rolling.rolling_ols_beta,
                         "(T,S),(...,T,K)->(...,N,K,S)"),
    "ols_beta": (jax_rolling.ols_beta, rolling.ols_beta, "(T,S),(T,K)->(_,S)"),
    "expanding_minmax_scale": (jax_rolling.expanding_minmax_scale,
                               rolling.expanding_minmax_scale, "(T,F)->(T,F),(T,F)"),
    "sqrtm_product_trace": (jax_sqrtm.sqrtm_product_trace, sqrtm.sqrtm_product_trace,
                            "(F,F),(F,F)->()"),
    "sample_windows": (jax_sampling.sample_windows, sampling.sample_windows,
                       "(T,F)->(N,W,F)"),
    "mfu_series": (jax_flops.mfu_series, flops.mfu_series, "(N,)->(N,)"),
}


@pytest.fixture(autouse=True)
def _contracts_on(monkeypatch):
    monkeypatch.delenv("HFREP_CONTRACTS", raising=False)
    torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


def _raises(fn, *args):
    """The ContractError message ``fn(*args)`` raises (the test fails if
    it raises nothing or anything else)."""
    with pytest.raises(Exception) as info:
        fn(*args)
    assert type(info.value).__name__ == "ContractError", repr(info.value)
    return str(info.value)


# ------------------------------------------------------------- the specs
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_the_jax_specs_parse_the_same_in_both(name):
    jax_fn, port_fn, port_spec = PAIRS[name]
    spec = jax_fn.__contract__
    assert contracts.parse_contract_spec(spec) == jax_contracts.parse_contract_spec(spec)
    assert port_fn.__contract__ == port_spec
    if port_spec != spec:
        # a batched position reads as JAX's per-lane one after its "..."
        j_ins, j_outs = jax_contracts.parse_contract_spec(spec)
        p_ins, p_outs = contracts.parse_contract_spec(port_spec)
        strip = [s[1:] if s and s[0] == contracts.BATCH else s for s in p_ins + p_outs]
        assert strip == [s for s in j_ins + j_outs if s != "*"]


@pytest.mark.parametrize("text", ["(B, T, F)", "()", "*", "(B,)", "(4, -1, _)", "B, T",
                                  "(B; T)", "(3.5)"])
def test_shape_spec_grammar_is_jax_s(text):
    def parse(mod):
        try:
            return "ok", mod.parse_shape_spec(text)
        except Exception as e:
            return type(e).__name__, str(e)
    assert parse(contracts) == parse(jax_contracts)


@pytest.mark.parametrize("spec", ["(T,S),(T,K)->(N,K,S)", "(B)", "(T,F)->", "((T)->(T)",
                                  "*,(T,F)->(N,W,F)", "(T,F)->(T,F),(T,F)"])
def test_contract_spec_grammar_is_jax_s(spec):
    def parse(mod):
        try:
            return "ok", mod.parse_contract_spec(spec)
        except Exception as e:
            return type(e).__name__, str(e)
    assert parse(contracts) == parse(jax_contracts)


def test_a_leading_ellipsis_is_the_port_s_alone():
    assert contracts.parse_shape_spec("(..., T, K)") == ("...", "T", "K")
    with pytest.raises(jax_contracts.ContractError, match="bad dim"):
        jax_contracts.parse_shape_spec("(..., T, K)")
    for bad in ("(T, ..., K)", "(..., ...)"):
        with pytest.raises(contracts.ContractError, match="bad dim"):
            contracts.parse_shape_spec(bad)


# -------------------------------------------------- runtime grammar cases
def _beta(y, x):
    return np.zeros((x.shape[1], y.shape[1]))


def _ident(x):
    return x


def _gram_wrong(x):
    return np.zeros((x.shape[1] + 1, x.shape[1]))


def _pair(x):
    return x, x


def _sample(key, data, n=3):
    return data


#: tests/test_analysis.py::TestRuntimeContract's cases: (spec, function,
#: arguments)
RUNTIME_CASES = {
    "accepts_consistent_shapes": ("(T,S),(T,K)->(K,S)", _beta,
                                  (np.zeros((10, 3)), np.zeros((10, 2)))),
    "rejects_rank_mismatch": ("(T,F)->(T,F)", _ident, (np.zeros((4, 4, 4)),)),
    "rejects_inconsistent_binding": ("(T,S),(T,K)->(K,S)", _beta,
                                     (np.zeros((10, 3)), np.zeros((11, 2)))),
    "output_checked_against_input_bindings": ("(T,F)->(F,F)", _gram_wrong,
                                              (np.zeros((5, 3)),)),
    "multi_output": ("(T,F)->(T,F),(T,F)", _pair, (np.zeros((4, 2)),)),
    "wildcard_and_scalars_skipped": ("*,(T,F)->(T,F)", _sample,
                                     (object(), np.zeros((6, 2)))),
    "literal_dim": ("(3,_)->(3,_)", _ident, (np.zeros((4, 2)),)),
}


def _outcome(deco, spec, fn, args):
    try:
        out = deco(spec)(fn)(*args)
    except Exception as e:
        return type(e).__name__, str(e)
    return "ok", [np.shape(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_runtime_cases_give_jax_s_verdict_and_message(case):
    spec, fn, args = RUNTIME_CASES[case]
    assert _outcome(contracts.contract, spec, fn, args) == \
        _outcome(jax_contracts.contract, spec, fn, args)


def test_the_switch_turns_the_check_off_in_both(monkeypatch):
    monkeypatch.setenv("HFREP_CONTRACTS", "0")
    bad = np.zeros((1, 2, 3))
    for mod in (contracts, jax_contracts):
        assert mod.contract("(T,F)->(T,F)")(_ident)(bad).shape == (1, 2, 3)
    # and on a real pair: a (2, 2) array of step times passes unchecked
    got = flops.mfu_series(np.ones((2, 2)), 48, 35)
    want = jax_flops.mfu_series(np.ones((2, 2)), 48, 35)
    assert got.shape == want.shape == (2, 2)


def test_leading_dims_bind_once_a_call():
    deco = contracts.contract("(T,S),(...,T,K)->(...,N,K,S)")

    def fn(y, x):
        return np.zeros(x.shape[:-2] + (x.shape[-2] - 1, x.shape[-1], y.shape[1]))

    f = deco(fn)
    for lead in ((), (3,), (2, 5)):
        assert f(np.zeros((6, 2)), np.zeros(lead + (6, 4))).shape == lead + (5, 4, 2)
    with pytest.raises(contracts.ContractError, match="symbol 'T'"):
        f(np.zeros((6, 2)), np.zeros((3, 7, 4)))
    with pytest.raises(contracts.ContractError, match="rank mismatch"):
        f(np.zeros((6, 2)), np.zeros((6,)))
    wrong = deco(lambda y, x: np.zeros((9, 5, 4, 2)))
    with pytest.raises(contracts.ContractError, match="leading dims"):
        wrong(np.zeros((6, 2)), np.zeros((3, 6, 4)))


# --------------------------------------------------- static grammar cases
#: tests/test_analysis.py::TestShapeContracts' fixtures (JAX006)
STATIC_CASES = {
    "rank_mismatch": """
        import jax.numpy as jnp
        x = jnp.zeros((4, 8, 3))  # shape: (B, T)
        """,
    "literal_dim_mismatch": """
        import jax.numpy as jnp
        x = jnp.zeros((4, 8))  # shape: (4, 16)
        """,
    "inconsistent_symbol": """
        import jax.numpy as jnp
        x = jnp.zeros((3, 4))  # shape: (B, B)
        """,
    "unparseable_comment": """
        import jax.numpy as jnp
        x = jnp.zeros((3,))  # shape: (3; 4)
        """,
    "contract_arity": """
        from hfrep_tpu.analysis.contracts import contract
        @contract("(A),(B),(C)->(D)")
        def f(x):
            return x
        """,
    "matching_annotation": """
        import jax.numpy as jnp
        n = 5
        x = jnp.zeros((4, 8, 3))   # shape: (4, W, F)
        y = jnp.ones((n, 3))       # shape: (N, F)
        z = jnp.zeros((4, 4))      # shape: (B, B)
        w = x.reshape(4, -1)       # shape: (B, WF)
        """,
    "annotation_on_continuation_line": """
        import jax.numpy as jnp
        x = jnp.zeros(
            (4, 8))  # shape: (B,)
        """,
    "nested_helper_return_not_checked_against_outer": """
        import jax.numpy as jnp
        from hfrep_tpu.analysis.contracts import contract
        @contract("(T,F)->(N,W,F)")
        def outer(x):
            def helper():
                return jnp.zeros((4, 4))
            return stack(x, helper())
        """,
    "function_form_reshape": """
        import jax.numpy as jnp
        y = jnp.reshape(x, n)        # shape: (n,)
        z = jnp.reshape(x, (4, 2))   # shape: (B, F)
        bad = jnp.reshape(x, (4, 2)) # shape: (B,)
        """,
    "trailing_prose_after_annotation": """
        import jax.numpy as jnp
        x = jnp.zeros((4, 8))  # shape: (B, F) fit on x[:i] (prefix)
        """,
    "docstring_example_not_scanned": '''
        def f():
            """Example: x = zeros((3,))  # shape: (B, T, F)"""
            return None
        ''',
    "random_normal_shape_checked": """
        import jax
        z = jax.random.normal(key, (32, 48, 35))  # shape: (B, W)
        """,
    "contract_literal_return_rank": """
        import jax.numpy as jnp
        from hfrep_tpu.analysis.contracts import contract
        @contract("(T,F)->(T,F)")
        def f(x):
            return jnp.zeros((4, 4, 4))
        """,
}


def _static(analyze, rules, src):
    return [(f.rule, f.line, f.col, f.message)
            for f in analyze(textwrap.dedent(src), path="snippet.py",
                             rules=[rules["JAX006"]])]


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_static_cases_give_jax_s_verdict_and_message(case):
    src = STATIC_CASES[case]
    assert _static(analyze_source, RULES_BY_ID, src) == \
        _static(jax_analyze_source, JAX_RULES, src)


def test_the_static_rule_reads_a_leading_ellipsis():
    src = """
        import torch
        from hfrep_tpu_torch.analysis.contracts import contract
        a = torch.zeros((2, 3, 4, 5))   # shape: (..., T, F)
        b = torch.zeros((4,))           # shape: (..., T, F)
        c = torch.zeros((4, 5))         # shape: (..., 4, 6)
        @contract("(...,T,F)->(...,T,F)")
        def f(x):
            return torch.zeros((4,))
        @contract("(...,T,F)->(...,T,F)")
        def g(x):
            return torch.zeros((2, 4, 4))
        """
    got = [(f.line, f.message.split(":")[0]) for f in analyze_source(
        textwrap.dedent(src), path="snippet.py", rules=[RULES_BY_ID["JAX006"]])]
    assert got == [(5, "rank mismatch"), (6, "dim mismatch"), (9, "`f` returns a rank-1 "
                                                                   "literal but @contract "
                                                                   "declares output (..., T, F)")]


# --------------------------------------------------- the decorated pairs
def _rolling_inputs(seed=0, t=40, s=3, k=4):
    g = np.random.default_rng(seed)
    return (g.normal(size=(t, s)).astype(np.float32),
            g.normal(size=(t, k)).astype(np.float32))


def _jax_starts(seed: int, n: int, t: int, w: int) -> np.ndarray:
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, t - w + 1))


def _calls(name):
    """(port output, JAX output, bar) on numpy-seeded inputs; the bar is
    None for bitwise."""
    y, x = _rolling_inputs()
    if name == "_window_stack":
        return rolling._window_stack(_t(x), 24), jax_rolling._window_stack(jnp.asarray(x), 24), None
    if name == "rolling_ols_beta":
        return (rolling.rolling_ols_beta(_t(y), _t(x), 24),
                jax_rolling.rolling_ols_beta(jnp.asarray(y), jnp.asarray(x), 24), 1e-3)
    if name == "ols_beta":
        return (rolling.ols_beta(_t(y), _t(x), True),
                jax_rolling.ols_beta(jnp.asarray(y), jnp.asarray(x), True), 1e-3)
    if name == "expanding_minmax_scale":
        return (rolling.expanding_minmax_scale(_t(x)),
                jax_rolling.expanding_minmax_scale(jnp.asarray(x)), None)
    if name == "sqrtm_product_trace":
        g = np.random.default_rng(5)
        s1 = np.cov(g.normal(size=(200, 6)), rowvar=False).astype(np.float32)
        s2 = np.cov(g.normal(size=(200, 6)), rowvar=False).astype(np.float32)
        return (sqrtm.sqrtm_product_trace(_t(s1), _t(s2)),
                jax_sqrtm.sqrtm_product_trace(jnp.asarray(s1), jnp.asarray(s2)), 1e-5)
    if name == "sample_windows":
        starts = _jax_starts(3, 16, x.shape[0], 12)
        return (sampling.sample_windows(_t(x), 16, 12, starts=torch.from_numpy(starts)),
                jax_sampling.sample_windows(jax.random.PRNGKey(3), jnp.asarray(x), 16, 12), None)
    dt = np.array([0.01, 0.02, 0.0, 0.5])
    return (flops.mfu_series(dt, 48, 35),
            jax_flops.mfu_series(dt, 48, 35) * (jax_flops.PEAK_BF16 / flops.PEAK_BF16), 1e-12)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_each_decorated_pair_gives_jax_s_output(name):
    got, want, bar = _calls(name)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if bar is None:
            np.testing.assert_array_equal(g, w)
        else:
            assert _scaled_err(np.nan_to_num(g), np.nan_to_num(w)) < bar


def _bad_calls(name):
    """[(what, port call, JAX call)] on shapes each contract refuses: a
    wrong rank, and a mismatched T where two inputs share it."""
    y, x = _rolling_inputs()
    ty, tx, jy, jx = _t(y), _t(x), jnp.asarray(y), jnp.asarray(x)
    if name == "_window_stack":
        return [("rank", lambda: rolling._window_stack(_t(x[:, 0]), 24),
                 lambda: jax_rolling._window_stack(jx[:, 0], 24))]
    if name == "rolling_ols_beta":
        return [("T", lambda: rolling.rolling_ols_beta(ty, tx[:-1], 24),
                 lambda: jax_rolling.rolling_ols_beta(jy, jx[:-1], 24)),
                ("rank", lambda: rolling.rolling_ols_beta(ty[..., None], tx, 24),
                 lambda: jax_rolling.rolling_ols_beta(jy[..., None], jx, 24))]
    if name == "ols_beta":
        return [("T", lambda: rolling.ols_beta(ty, tx[:-1]),
                 lambda: jax_rolling.ols_beta(jy, jx[:-1])),
                ("rank", lambda: rolling.ols_beta(ty[:, 0], tx),
                 lambda: jax_rolling.ols_beta(jy[:, 0], jx))]
    if name == "expanding_minmax_scale":
        return [("rank", lambda: rolling.expanding_minmax_scale(tx[None]),
                 lambda: jax_rolling.expanding_minmax_scale(jx[None]))]
    if name == "sqrtm_product_trace":
        e = np.eye(4, dtype=np.float32)
        return [("F", lambda: sqrtm.sqrtm_product_trace(_t(e), _t(np.eye(5, dtype=np.float32))),
                 lambda: jax_sqrtm.sqrtm_product_trace(jnp.asarray(e), jnp.eye(5))),
                ("rank", lambda: sqrtm.sqrtm_product_trace(_t(e[0]), _t(e)),
                 lambda: jax_sqrtm.sqrtm_product_trace(jnp.asarray(e[0]), jnp.asarray(e)))]
    if name == "sample_windows":
        starts = torch.zeros(4, dtype=torch.long)
        return [("rank", lambda: sampling.sample_windows(tx[None], 4, 12, starts=starts),
                 lambda: jax_sampling.sample_windows(jax.random.PRNGKey(0), jx[None], 4, 12))]
    return [("rank", lambda: flops.mfu_series(np.ones((2, 2)), 48, 35),
             lambda: jax_flops.mfu_series(np.ones((2, 2)), 48, 35))]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_each_decorated_pair_refuses_the_same_bad_shapes(name):
    same_spec = PAIRS[name][0].__contract__ == PAIRS[name][2]
    for what, port_call, jax_call in _bad_calls(name):
        got, want = _raises(port_call), _raises(jax_call)
        phrase = "rank mismatch" if what == "rank" else f"symbol '{what}'"
        assert phrase in got and phrase in want, (got, want)
        if same_spec:
            # the same spec text: the same words, shapes printed alike
            assert got == want, (got, want)


def test_ols_beta_raises_jax_s_error_not_a_value_error():
    y, x = _rolling_inputs()
    with pytest.raises(contracts.ContractError, match="ols_beta arg\\[1\\]: symbol 'T'"):
        rolling.ols_beta(_t(y), _t(x[:-1]))


# --------------------------------------------- lanes: "..." against vmap
@pytest.mark.parametrize("lanes", [(3,), (2, 2)])
def test_lane_batched_calls_equal_jax_s_vmap(lanes):
    g = np.random.default_rng(9)
    y = g.normal(size=(36, 3)).astype(np.float32)
    x = g.normal(size=lanes + (36, 5)).astype(np.float32)
    flat = jnp.asarray(x.reshape((-1,) + x.shape[-2:]))
    want_b = jax.vmap(lambda xl: jax_rolling.rolling_ols_beta(jnp.asarray(y), xl, 24))(flat)
    want_w = jax.vmap(lambda xl: jax_rolling._window_stack(xl, 24))(flat)
    got_b = rolling.rolling_ols_beta(_t(y), _t(x), 24)
    got_w = rolling._window_stack(_t(x), 24)
    assert tuple(got_b.shape) == lanes + tuple(want_b.shape[1:])
    assert _scaled_err(got_b.reshape(want_b.shape).numpy(), want_b) < 1e-3
    np.testing.assert_array_equal(got_w.reshape(want_w.shape).numpy(), np.asarray(want_w))
