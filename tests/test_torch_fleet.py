"""The port's fleet control plane against the JAX package's on the same
streams (twins of every test of ``tests/test_fleet.py``), on the CPU.

Each twin runs one request stream through both packages' ``fleet``
modules (router, replicas, merge, scale-out policy) and holds the port to
the original test's claim and to the JAX package: assignments exact,
merged timings bit for bit, ``FleetResult.summary()`` and scale-out
decision records equal. Beyond the twins:

* ``compass_pricer`` on a tiny budget (GA 8 x 3, ``n_blocks=2``, the
  dense backend, ``device="cpu"``) under ``plan_scale_out`` with keep,
  re_search and add_replica: the searched encodings exact, latencies and
  scores within the goldens' rtol of 1e-3, ``mc_total`` exact, and
  re_search warm-started from the port's own ``MappingSearchOutput``;
* ``MeasuredReplica`` over the port's ``AsyncLLMService`` on reduced
  qwen1.5-0.5b (weights carried across from the JAX package): a
  1-replica fleet's rollout and priced timings equal a direct serve of
  the unsplit stream bit for bit, and a 2-replica round-robin fleet
  serves every request once, each replica as a direct serve of its own
  sub-stream;
* the pricer's search and a measured replica's default service run on
  CUDA and raise where there is none.
"""
import dataclasses
import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import fleet as j_fleet  # noqa: E402
from repro.configs import all_archs as j_archs  # noqa: E402
from repro.core import objectives as j_objectives  # noqa: E402
from repro.core import streams as j_streams  # noqa: E402
from repro.core import traces as j_traces  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.core.ga import GAConfig as JGAConfig  # noqa: E402
from repro.core.hardware import make_hardware as j_make_hardware  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.serving.scheduler import get_scheduler as j_get_scheduler  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import fleet as t_fleet  # noqa: E402
from repro_torch.core import objectives as t_objectives  # noqa: E402
from repro_torch.core import streams as t_streams  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402
from repro_torch.core import workload as t_workload  # noqa: E402
from repro_torch.core.compass import MappingSearchOutput  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.hardware import make_hardware  # noqa: E402
from repro_torch.core.interop import params_from_jax  # noqa: E402
from repro_torch.serving import AsyncLLMService, ServiceConfig  # noqa: E402
from repro_torch.serving.scheduler import get_scheduler  # noqa: E402
from repro_torch.serving.service import service_requests  # noqa: E402

CPU = "cpu"
RTOL = 1e-3                   # the goldens' rule
POLICIES = ["round_robin", "least_loaded", "slo_class"]
SLOTS, ITERS = 4, 4096

# one namespace per package: the twins build the same objects from each
J = SimpleNamespace(name="jax", fleet=j_fleet, streams=j_streams,
                    objectives=j_objectives, traces=j_traces,
                    workload=j_workload, get_scheduler=j_get_scheduler,
                    GAConfig=JGAConfig, make_hardware=j_make_hardware)
T = SimpleNamespace(name="torch", fleet=t_fleet, streams=t_streams,
                    objectives=t_objectives, traces=t_traces,
                    workload=t_workload, get_scheduler=get_scheduler,
                    GAConfig=GAConfig, make_hardware=make_hardware)


def _both(fn):
    """``fn`` run on the JAX package, then on the port: (jax, torch)."""
    return fn(J), fn(T)


def _stream(pkg):
    return pkg.streams.RequestStream(
        "fleet-mix", trace=pkg.traces.SHAREGPT, rate=2.0, n_requests=24,
        warm_fraction=0.25, max_new_tokens_cap=16, seed=7)


def _overload(pkg):
    return pkg.streams.RequestStream(
        "overload", trace=pkg.traces.SHAREGPT, rate=1.0, n_requests=32,
        max_new_tokens_cap=8, seed=3)


def _replica(pkg, name="r0", mc=3.0, **kw):
    kw.setdefault("pricer", pkg.fleet.unit_pricer())
    kw.setdefault("scheduler", "orca")
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("max_iters", ITERS)
    return pkg.fleet.PlannedReplica(mc_total=mc, name=name, **kw)


def _fleet(pkg, n, policy="round_robin", **kw):
    return pkg.fleet.Fleet([_replica(pkg, f"r{i}", **kw) for i in range(n)],
                           policy=policy)


def _small_fleet(pkg, max_iters=ITERS):
    return pkg.fleet.Fleet([pkg.fleet.PlannedReplica(
        pricer=pkg.fleet.unit_pricer(), scheduler="orca", max_slots=2,
        max_iters=max_iters, mc_total=1.0, name="r0")])


def _goodput(pkg, ttft, tpot):
    return pkg.objectives.GoodputUnderSLO(ttft_slo_s=ttft, tpot_slo_s=tpot)


def _same_timings(got, want):
    for key in ("ttft_s", "tpot_s", "finished", "warm"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    assert got.makespan_s == want.makespan_s
    assert got.truncated == want.truncated


def _batches(ro):
    """A rollout's batches as plain tuples (each package has its own
    ``Request`` class)."""
    return [[(r.kind, r.q_len, r.kv_len) for r in b] for b in ro.batches]


def _same_rollout(got, want):
    assert _batches(got) == _batches(want)
    for key in ("warm", "arrival_b", "first_b", "done_b", "n_new_tokens"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    assert got.truncated == want.truncated


def _same_fleet_result(got, want):
    """Route, every replica's rollout and timings, the merged timings and
    the summary record: equal."""
    np.testing.assert_array_equal(got.route.assignment, want.route.assignment)
    for g, w in zip(got.route.indices, want.route.indices, strict=True):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.replica_results, want.replica_results, strict=True):
        assert (g.replica, g.mc_total) == (w.replica, w.mc_total)
        _same_rollout(g.rollout, w.rollout)
        _same_timings(g.timings, w.timings)
    _same_timings(got.timings, want.timings)
    assert got.mc_total == want.mc_total
    assert got.summary() == want.summary()


def _same_decision(got, want):
    assert got.rate == want.rate
    assert got.best.action == want.best.action
    assert got.record() == want.record()
    for g, w in zip(got.options, want.options, strict=True):
        assert (g.action, g.fleet.n_replicas, g.score) == \
            (w.action, w.fleet.n_replicas, w.score)
        _same_fleet_result(g.result, w.result)


# ---------------------------------------------------------------------------
# Keystone: 1-replica fleet == unsplit serve, bit for bit
# ---------------------------------------------------------------------------

class TestOneReplicaParity:

    @pytest.mark.parametrize("policy", POLICIES)
    def test_merged_timings_bit_identical_to_unsplit(self, policy):
        def run(pkg):
            st = _stream(pkg)
            fr = pkg.fleet.Fleet([_replica(pkg)], policy=policy).serve(st)
            ro = pkg.streams.rollout(st, pkg.get_scheduler("orca"),
                                     max_slots=SLOTS, max_iters=ITERS)
            return fr, ro, ro.timings(pkg.fleet.unit_pricer()(ro))

        (j_fr, _, _), (fr, ro, direct) = _both(run)
        _same_timings(fr.timings, direct)
        assert fr.replica_results[0].rollout.batches == ro.batches
        _same_fleet_result(fr, j_fr)

    def test_one_replica_score_matches_direct_objective(self):
        def run(pkg):
            st = _stream(pkg)
            fr = pkg.fleet.Fleet([_replica(pkg, mc=3.0)]).serve(st)
            ro = pkg.streams.rollout(st, pkg.get_scheduler("orca"),
                                     max_slots=SLOTS, max_iters=ITERS)
            obj = pkg.objectives.GoodputPerDollar(ttft_slo_s=0.5,
                                                  tpot_slo_s=0.1)
            direct = -obj.score(0.0, 0.0, mc=3.0,
                                timings=ro.timings(pkg.fleet.unit_pricer()(ro)))
            return fr.goodput_per_dollar(obj), direct

        (j_gpd, j_direct), (gpd, direct) = _both(run)
        assert gpd == direct
        assert (gpd, direct) == (j_gpd, j_direct)


# ---------------------------------------------------------------------------
# Routing: determinism, rate-invariance, policy semantics
# ---------------------------------------------------------------------------

class TestRouting:

    @pytest.mark.parametrize("policy", POLICIES)
    def test_assignment_rate_invariant(self, policy):
        def run(pkg):
            st = _stream(pkg)
            base = pkg.fleet.route_stream(st, 3, policy)
            rerated = [pkg.fleet.route_stream(st.with_rate(rate), 3, policy)
                       for rate in (0.25, 8.0, 64.0)]
            return base, rerated

        (j_base, _), (base, rerated) = _both(run)
        np.testing.assert_array_equal(base.assignment, j_base.assignment)
        for ra in rerated:
            np.testing.assert_array_equal(base.assignment, ra.assignment)
            for s_lo, s_hi in zip(base.substreams, ra.substreams):
                for a, b in zip(s_lo.sample(), s_hi.sample()):
                    assert (a.prompt_len, a.max_new_tokens,
                            a.warm_context) == \
                        (b.prompt_len, b.max_new_tokens, b.warm_context)

    def test_round_robin_assignment(self):
        j_a, a = _both(lambda pkg: pkg.fleet.assign(
            _stream(pkg).sample(), 3, "round_robin"))
        np.testing.assert_array_equal(a, np.arange(len(a)) % 3)
        np.testing.assert_array_equal(a, j_a)

    def test_least_loaded_balances_token_work(self):
        def work(r):
            return r.max_new_tokens if r.warm \
                else r.prompt_len + r.max_new_tokens

        def run(pkg):
            reqs = _stream(pkg).sample()

            def spread(a):
                loads = np.zeros(3)
                for i, r in enumerate(reqs):
                    loads[a[i]] += work(r)
                return loads.max() - loads.min()

            ll = pkg.fleet.assign(reqs, 3, "least_loaded")
            return ll, spread(ll), spread(pkg.fleet.assign(reqs, 3,
                                                           "round_robin"))

        (j_ll, _, _), (ll, s_ll, s_rr) = _both(run)
        assert s_ll < s_rr
        np.testing.assert_array_equal(ll, j_ll)

    def test_slo_class_isolates_warm_from_cold(self):
        def run(pkg):
            reqs = _stream(pkg).sample()
            return (pkg.fleet.assign(reqs, 4, "slo_class"),
                    np.asarray([r.warm for r in reqs]))

        (j_a, _), (a, warm) = _both(run)
        assert not set(a[warm].tolist()) & set(a[~warm].tolist())
        np.testing.assert_array_equal(a, j_a)

    def test_slo_class_fewer_replicas_than_classes_shares(self):
        j_a, a = _both(lambda pkg: pkg.fleet.assign(_stream(pkg).sample(), 1,
                                                    "slo_class"))
        np.testing.assert_array_equal(a, np.zeros(len(a), dtype=int))
        np.testing.assert_array_equal(a, j_a)

    @pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
    def test_validation(self, pkg):
        reqs = _stream(pkg).sample()
        with pytest.raises(ValueError, match="at least one replica"):
            pkg.fleet.assign(reqs, 0, "round_robin")
        with pytest.raises(ValueError, match="unknown routing policy"):
            pkg.fleet.assign(reqs, 2, "random")
        fixed = pkg.streams.RequestStream.fixed_batches(
            [[pkg.workload.Request(pkg.workload.PREFILL, 8, 8)]])
        with pytest.raises(ValueError, match="fixed-batch"):
            pkg.fleet.route_stream(fixed, 2)


# ---------------------------------------------------------------------------
# split/merge mechanics
# ---------------------------------------------------------------------------

class TestSplitMerge:

    def test_split_partitions_and_indices_invert(self):
        def run(pkg):
            st = _stream(pkg)
            return pkg.fleet.route_stream(st, 3, "least_loaded"), st.sample()

        (j_ra, _), (ra, reqs) = _both(run)
        all_ix = np.concatenate(ra.indices)
        assert sorted(all_ix.tolist()) == list(range(len(reqs)))
        for sub, ix, j_ix in zip(ra.substreams, ra.indices, j_ra.indices,
                                 strict=True):
            assert [r.prompt_len for r in sub.sample()] == \
                [reqs[j].prompt_len for j in ix]
            np.testing.assert_array_equal(ix, j_ix)

    @pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
    def test_split_validation(self, pkg):
        st = _stream(pkg)
        with pytest.raises(ValueError, match="shape"):
            pkg.streams.split_stream(st, [0, 1], 2)
        with pytest.raises(ValueError, match=r"\[0, 2\)"):
            pkg.streams.split_stream(st, [5] * st.n_requests, 2)

    @pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
    def test_merge_validation(self, pkg):
        st = _stream(pkg)
        ra = pkg.fleet.route_stream(st, 2, "round_robin")
        parts = [pkg.fleet.Fleet([_replica(pkg)]).serve(sub).timings
                 for sub in ra.substreams]
        with pytest.raises(ValueError, match="overlap"):
            pkg.streams.merge_timings(parts, [ra.indices[0], ra.indices[0]],
                                      st.n_requests)
        with pytest.raises(ValueError, match="index set"):
            pkg.streams.merge_timings(
                parts, [ra.indices[0], ra.indices[1][:-1]], st.n_requests)

    def test_uncovered_requests_read_unserved(self):
        def run(pkg):
            st = _stream(pkg)
            ra = pkg.fleet.route_stream(st, 2, "round_robin")
            ro = pkg.streams.rollout(ra.substreams[0],
                                     pkg.get_scheduler("orca"),
                                     max_slots=SLOTS, max_iters=ITERS)
            t = ro.timings(pkg.fleet.unit_pricer()(ro))
            return ra, pkg.streams.merge_timings([t], [ra.indices[0]],
                                                 st.n_requests)

        (_, j_merged), (ra, merged) = _both(run)
        missing = np.ones(len(merged.ttft_s), dtype=bool)
        missing[ra.indices[0]] = False
        assert np.isinf(merged.ttft_s[missing]).all()
        assert np.isinf(merged.tpot_s[missing]).all()
        assert not merged.finished[missing].any()
        _same_timings(merged, j_merged)

    def test_empty_substream_serves_cleanly(self):
        def run(pkg):
            st = _stream(pkg)
            sub, _ = pkg.streams.split_stream(st, np.ones(st.n_requests, int),
                                              2)
            return sub[0], _replica(pkg).serve(sub[0])

        (_, j_res), (sub, res) = _both(run)
        assert sub.n_requests == 0
        assert not res.truncated
        assert res.timings.ttft_s.shape == (0,)
        _same_rollout(res.rollout, j_res.rollout)
        _same_timings(res.timings, j_res.timings)


# ---------------------------------------------------------------------------
# Fleet accounting
# ---------------------------------------------------------------------------

class TestFleetAccounting:

    def test_mc_sums_and_makespan_is_max(self):
        j_fr, fr = _both(lambda pkg: _fleet(pkg, 3, mc=2.5).serve(
            _stream(pkg)))
        assert fr.mc_total == 7.5
        assert fr.timings.makespan_s == max(
            r.timings.makespan_s for r in fr.replica_results)
        _same_fleet_result(fr, j_fr)

    @pytest.mark.parametrize("policy", POLICIES)
    def test_every_request_served_exactly_once(self, policy):
        j_fr, fr = _both(lambda pkg: _fleet(pkg, 3, policy=policy).serve(
            _stream(pkg)))
        assert fr.timings.finished.all()
        assert np.isfinite(fr.timings.cold_ttft_s).all()
        _same_fleet_result(fr, j_fr)

    def test_heterogeneous_fleet_dollars(self):
        def run(pkg):
            fleet = pkg.fleet.Fleet(
                [_replica(pkg, "big", mc=10.0),
                 _replica(pkg, "small", mc=1.0, max_slots=2)])
            return fleet.serve(_stream(pkg))

        j_fr, fr = _both(run)
        assert fr.mc_total == 11.0
        assert {r.replica for r in fr.replica_results} == {"big", "small"}
        _same_fleet_result(fr, j_fr)

    def test_summary_record_is_json_ready(self):
        j_rec, rec = _both(lambda pkg: _fleet(pkg, 2).serve(
            _stream(pkg)).summary())
        json.dumps(rec)
        assert rec["n_replicas"] == 2
        assert sum(rec["loads"]) == 24
        assert rec["ttft_p99_s"] > 0 and rec["tpot_p50_s"] > 0
        assert rec == j_rec

    def test_goodput_positive_and_scales(self):
        def run(pkg):
            st = _stream(pkg).with_rate(16.0)
            one = pkg.fleet.Fleet([_replica(pkg, mc=1.0)]).serve(st)
            three = _fleet(pkg, 3, mc=1.0).serve(st)
            obj = _goodput(pkg, 0.25, 0.05)
            return three.goodput(obj), one.goodput(obj)

        j_g, g = _both(run)
        assert g[0] > g[1] > 0
        assert g == j_g


# ---------------------------------------------------------------------------
# Scale-out policy search
# ---------------------------------------------------------------------------

class TestScaleOut:

    def test_underload_keeps(self):
        j_dec, dec = _both(lambda pkg: pkg.fleet.plan_scale_out(
            _small_fleet(pkg), _overload(pkg), rate=0.05,
            objective=_goodput(pkg, 5.0, 1.0)))
        assert dec.best.action == "keep"
        _same_decision(dec, j_dec)

    def test_overload_adds_replica(self):
        j_dec, dec = _both(lambda pkg: pkg.fleet.plan_scale_out(
            _small_fleet(pkg), _overload(pkg), rate=8.0,
            objective=_goodput(pkg, 0.5, 0.05)))
        assert dec.best.action == "add_replica"
        by = {o.action: o for o in dec.options}
        assert by["add_replica"].score > by["keep"].score > 0
        _same_decision(dec, j_dec)

    def test_truncated_option_refused(self):
        j_dec, dec = _both(lambda pkg: pkg.fleet.plan_scale_out(
            _small_fleet(pkg, max_iters=100), _overload(pkg), rate=32.0,
            objective=_goodput(pkg, 5.0, 1.0)))
        by = {o.action: o for o in dec.options}
        assert by["keep"].score == float("-inf")
        assert "truncated" in by["keep"].note
        assert dec.best.action == "add_replica"
        _same_decision(dec, j_dec)

    def test_scheduler_swap_and_resume_options(self):
        j_dec, dec = _both(lambda pkg: pkg.fleet.plan_scale_out(
            _small_fleet(pkg), _overload(pkg), rate=8.0,
            objective=_goodput(pkg, 0.5, 0.05),
            schedulers=("vllm", "chunked_prefill"),
            re_search=lambda rep, res: dataclasses.replace(
                rep, name=f"{rep.name}'")))
        actions = [o.action for o in dec.options]
        assert actions == ["keep", "scheduler:vllm",
                           "scheduler:chunked_prefill", "re_search",
                           "add_replica"]
        assert all(np.isfinite(o.score) for o in dec.options)
        rec = dec.record()
        assert rec["best"] == dec.best.action
        assert len(rec["options"]) == 5
        _same_decision(dec, j_dec)

    def test_decision_record_is_json_ready(self):
        j_rec, rec = _both(lambda pkg: pkg.fleet.plan_scale_out(
            _small_fleet(pkg), _overload(pkg), rate=2.0,
            objective=_goodput(pkg, 0.5, 0.05)).record())
        json.dumps(rec)
        assert rec == j_rec

    def test_auto_clone_keeps_the_replica_fields(self):
        """``add_replica`` by default clones the last replica with
        ``dataclasses.replace``: the port's replicas stay dataclasses with
        the JAX package's fields."""
        for j_cls, cls in ((j_fleet.PlannedReplica, t_fleet.PlannedReplica),
                           (j_fleet.MeasuredReplica,
                            t_fleet.MeasuredReplica)):
            assert [(f.name, f.default) for f in dataclasses.fields(cls)] \
                == [(f.name, f.default) for f in dataclasses.fields(j_cls)]
        dec = t_fleet.plan_scale_out(_small_fleet(T), _overload(T), rate=2.0)
        added = dec.options[-1].fleet.replicas
        assert [r.name for r in added] == ["r0", "r0+1"]
        assert dataclasses.replace(added[1], name="r0") == added[0]


# ---------------------------------------------------------------------------
# compass_pricer: a mapping search per serve, on a tiny budget
# ---------------------------------------------------------------------------

SPEC_ARGS = ("tiny", 512, 8, 8, 64, 2048, 32000, 8)


def _pricer_decision(pkg, rate=4.0):
    """``plan_scale_out`` (keep, re_search, add_replica) of a 1-replica
    fleet whose replica prices each rollout by a goodput mapping search on
    a fixed hardware point; re_search warm-starts from the keep serve's
    search output."""
    spec = pkg.workload.LLMSpec(*SPEC_ARGS)
    hw = pkg.make_hardware(64, "M", tensor_parallel=2)
    small = pkg.traces.TraceDistribution("small", mean_input=48,
                                         mean_output=12, max_len=256)
    stream = pkg.streams.RequestStream("pricer", trace=small, rate=1.0,
                                       n_requests=8, warm_fraction=0.25,
                                       max_new_tokens_cap=4, seed=0)
    obj = _goodput(pkg, 0.02, 0.00278)       # binding at this scale
    kw = {} if pkg is J else {"device": CPU}

    def replica(name="r0", warm_from=None):
        return pkg.fleet.PlannedReplica(
            pricer=pkg.fleet.compass_pricer(
                spec, hw, pkg.GAConfig(population=8, generations=3, seed=0),
                objective=obj, n_blocks=2, timing_backend="dense",
                warm_from=warm_from, **kw),
            scheduler="orca", max_slots=2, max_iters=512, name=name)

    def re_search(rep, res):
        return replica(f"{rep.name}'", res.meta["search_output"])

    return pkg.fleet.plan_scale_out(pkg.fleet.Fleet([replica()]), stream,
                                    rate, objective=obj, re_search=re_search)


@functools.cache
def _pricer_decisions():
    return _both(_pricer_decision)


def test_compass_pricer_matches_jax_package():
    """Every option's searched mappings exact, its per-batch latencies and
    score within RTOL, its dollars exact; the schedule and the route
    equal."""
    want, got = _pricer_decisions()
    assert [o.action for o in got.options] == \
        ["keep", "re_search", "add_replica"]
    assert got.best.action == want.best.action
    for g, w in zip(got.options, want.options, strict=True):
        assert g.fleet.n_replicas == w.fleet.n_replicas
        assert np.isfinite(g.score) and g.score > 0
        np.testing.assert_allclose(g.score, w.score, rtol=RTOL)
        np.testing.assert_array_equal(g.result.route.assignment,
                                      w.result.route.assignment)
        assert g.result.mc_total == w.result.mc_total
        for gr, wr in zip(g.result.replica_results, w.result.replica_results,
                          strict=True):
            _same_rollout(gr.rollout, wr.rollout)
            assert gr.mc_total == wr.mc_total
            g_out, w_out = gr.meta["search_output"], wr.meta["search_output"]
            assert sorted(g_out.encodings) == sorted(w_out.encodings)
            for key, enc in w_out.encodings.items():
                np.testing.assert_array_equal(g_out.encodings[key].segmentation,
                                              enc.segmentation)
                np.testing.assert_array_equal(
                    g_out.encodings[key].layer_to_chip, enc.layer_to_chip)
            np.testing.assert_allclose(g_out.batch_latencies,
                                       w_out.batch_latencies, rtol=RTOL)
            np.testing.assert_allclose(gr.timings.ttft_s, wr.timings.ttft_s,
                                       rtol=RTOL)
            for key in ("mode", "rounds", "converged", "ga_evaluations"):
                assert gr.meta[key] == wr.meta[key], key


def test_re_search_warm_starts_from_the_ports_search_output():
    """The keep serve's meta carries the port's own ``MappingSearchOutput``,
    which the port's co-search accepts as ``warm_from``; the re-searched
    replica's search ran the joint mode from it."""
    _, got = _pricer_decisions()
    keep, re_searched = got.options[0], got.options[1]
    donor = keep.result.replica_results[0].meta["search_output"]
    assert isinstance(donor, MappingSearchOutput)
    rep = re_searched.fleet.replicas[0]
    assert rep.name == "r0'"
    assert re_searched.result.replica_results[0].meta["mode"] == "joint"
    assert re_searched.score >= keep.score * (1 - RTOL)


def test_pricer_and_measured_replica_default_to_cuda():
    """The pricer's search and a measured replica's service run on CUDA
    unless told otherwise, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    spec = t_workload.LLMSpec(*SPEC_ARGS)
    hw = make_hardware(64, "M", tensor_parallel=2)
    stream = t_streams.RequestStream.from_requests(
        [t_streams.StreamRequest(8, 2, 0)], name="one")
    rep = t_fleet.PlannedReplica(
        pricer=t_fleet.compass_pricer(
            spec, hw, GAConfig(population=4, generations=1), n_blocks=1),
        max_slots=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rep.serve(stream)
    _, _, cfg, params = _qwen()
    measured = t_fleet.MeasuredReplica(
        service=lambda: AsyncLLMService(params, cfg, ServiceConfig(
            max_batch=2, max_len=64, block_len=16)), vocab=cfg.vocab)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measured.serve(stream)


# ---------------------------------------------------------------------------
# Measured path: fleets over the port's paged service
# ---------------------------------------------------------------------------

MEASURED_ARCH = "qwen1.5-0.5b"


@functools.cache
def _qwen():
    j_cfg = j_archs()[MEASURED_ARCH].reduced()
    cfg = t_configs.get(MEASURED_ARCH).reduced()
    j_params = j_init_model(jax.random.PRNGKey(0), j_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, CPU)
    return j_cfg, j_params, cfg, params


def _make_service():
    _, _, cfg, params = _qwen()
    return AsyncLLMService(params, cfg, ServiceConfig(
        max_batch=3, max_len=64, block_len=16), device=CPU)


def _make_jax_service():
    from repro.serving import AsyncLLMService as JAsyncLLMService
    from repro.serving import ServiceConfig as JServiceConfig

    j_cfg, j_params, _, _ = _qwen()
    return JAsyncLLMService(j_params, j_cfg, JServiceConfig(
        max_batch=3, max_len=64, block_len=16))


def _direct(stream):
    cfg = _qwen()[2]
    return _make_service().serve_sync(
        service_requests(stream, cfg.vocab), get_scheduler("orca"),
        stream_name=stream.name)


def _measured_stream(pkg):
    s = pkg.streams
    return s.RequestStream.from_requests(
        [s.StreamRequest(10, 3, 0),
         s.StreamRequest(6, 2, 1, warm_context=9),
         s.StreamRequest(8, 4, 2),
         s.StreamRequest(12, 2, 2)], name="measured-fleet")


def _measured_fleet(pkg, n_replicas, **kw):
    """``n_replicas`` measured replicas over ``pkg``'s own paged service,
    served on ``pkg``'s copy of the measured stream: (stream, result)."""
    make = _make_service if pkg is T else _make_jax_service
    reps = [pkg.fleet.MeasuredReplica(service=make, vocab=_qwen()[2].vocab,
                                      scheduler="orca", mc_total=2.0,
                                      name=f"m{i}")
            for i in range(n_replicas)]
    stream = _measured_stream(pkg)
    return stream, pkg.fleet.Fleet(reps, **kw).serve(stream)


def _same_measured_fleet(got, want, lat):
    """Route, each replica's rollout and service counters, and the merged
    timings priced with the common latency vectors ``lat``: equal."""
    for g, w in zip(got.route.indices, want.route.indices, strict=True):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.replica_results, want.replica_results, strict=True):
        assert (g.replica, g.mc_total) == (w.replica, w.mc_total)
        _same_rollout(g.rollout, w.rollout)
        assert g.meta == w.meta
    merged = [t_streams.merge_timings(
        [r.rollout.timings(v) for r, v in zip(fr.replica_results, lat,
                                              strict=True)],
        fr.route.indices, len(np.concatenate(fr.route.indices)))
        for fr in (got, want)]
    _same_timings(*merged)
    assert got.mc_total == want.mc_total


def test_measured_one_replica_fleet_parity():
    """A 1-replica fleet over each package's own service: the port's
    rollout equals a direct serve of the unsplit stream, and priced with
    one common latency vector its merged timings equal the direct serve's,
    bit for bit; the schedule is the planner's; and route, rollout,
    service counters and priced timings equal the JAX package's fleet."""
    stream, fr = _measured_fleet(T, 1)
    direct = _direct(stream)
    ro = fr.replica_results[0].rollout
    assert ro.batches == direct.rollout.batches
    for key in ("warm", "first_b", "done_b"):
        np.testing.assert_array_equal(getattr(ro, key),
                                      getattr(direct.rollout, key))
    lat = np.linspace(0.01, 0.02, len(ro.batches))
    merged = t_streams.merge_timings([ro.timings(lat)], fr.route.indices,
                                     stream.n_requests)
    dt = direct.timings(lat)
    for key in ("ttft_s", "tpot_s", "warm"):
        np.testing.assert_array_equal(getattr(merged, key), getattr(dt, key))
    assert merged.makespan_s == dt.makespan_s
    assert fr.mc_total == 2.0
    assert fr.replica_results[0].meta["unfinished"] == 0
    planned = t_streams.rollout(stream, get_scheduler("orca"), max_slots=3,
                                max_iters=10_000)
    _same_rollout(ro, planned)
    _, j_fr = _measured_fleet(J, 1)
    _same_measured_fleet(fr, j_fr, [lat])


def test_measured_round_robin_fleet_serves_each_request_once():
    """Two measured replicas behind round robin: every request finishes
    exactly once, each replica's rollout equals a direct serve of its own
    sub-stream, and route, rollouts, service counters and priced timings
    equal the JAX package's fleet."""
    stream, fr = _measured_fleet(T, 2, policy="round_robin")
    ix = np.concatenate(fr.route.indices)
    assert sorted(ix.tolist()) == list(range(stream.n_requests))
    assert fr.route.loads().tolist() == [2, 2]
    assert fr.mc_total == 4.0
    for res, sub in zip(fr.replica_results, fr.route.substreams, strict=True):
        direct = _direct(sub)
        assert res.rollout.batches == direct.rollout.batches
        for key in ("warm", "first_b", "done_b"):
            np.testing.assert_array_equal(getattr(res.rollout, key),
                                          getattr(direct.rollout, key))
        assert res.meta["unfinished"] == 0
    lat = [np.linspace(0.01, 0.02, len(r.rollout.batches))
           for r in fr.replica_results]
    merged = t_streams.merge_timings(
        [r.rollout.timings(v) for r, v in zip(fr.replica_results, lat)],
        fr.route.indices, stream.n_requests)
    assert merged.finished.all()
    _, j_fr = _measured_fleet(J, 2, policy="round_robin")
    _same_measured_fleet(fr, j_fr, lat)


def test_fleet_frontier_matches_the_recorded_jax_frontier():
    """The reduced fleet frontier of ``benchmarks/bench_serving.py``
    (llama3.2-3b spec, 12 ShareGPT requests, replicas of 2 slots on
    ``make_hardware(512, "L", tensor_parallel=8)`` with alternating WS / OS
    chiplets, GA 16 x 6 over 2 blocks, SLOs at the 60th percentile of a
    latency pre-search at rate 2) on the port: at each rate the JAX
    package's recorded CPU frontier (``BENCH_serving.json``), best action
    and replica count exact, every option's goodput per dollar to the
    record's 6 decimals."""
    import os

    from repro_torch.configs import llm_spec
    from repro_torch.core.compass import search_mapping

    with open(os.path.join(os.path.dirname(__file__), "..",
                           "BENCH_serving.json")) as f:
        record = json.load(f)["fleet_frontier"]
    spec = llm_spec("llama3.2-3b")
    hw = make_hardware(512, "L", tensor_parallel=8)
    hw = hw.replace(layout=tuple(["WS", "OS"] * (hw.n_chiplets // 2)))
    base = t_streams.RequestStream(
        "sharegpt-fleet", trace=t_traces.SHAREGPT, rate=1.0,
        n_requests=record["n_requests"], warm_fraction=0.25,
        max_new_tokens_cap=8, seed=0)
    ga = GAConfig(population=16, generations=6)
    slots = record["max_slots_per_replica"]
    pre_ro = t_streams.rollout(base.with_rate(2.0), get_scheduler("orca"),
                               max_slots=slots, max_iters=2048)
    pre_mbs = [hw.micro_batch_decode
               if any(r.kind == t_workload.DECODE for r in b)
               else hw.micro_batch_prefill for b in pre_ro.batches]
    pre = search_mapping(spec, pre_ro.batches, hw, pre_mbs, ga,
                         objective="latency", n_blocks=2, device=CPU)
    tim = pre_ro.timings(pre.batch_latencies)
    obj = t_objectives.GoodputUnderSLO(
        ttft_slo_s=float(np.percentile(tim.cold_ttft_s, 60)),
        tpot_slo_s=float(np.percentile(tim.tpot_s, 60)))
    assert record["objective"] == (f"goodput_per_dollar@ttft"
                                   f"{obj.ttft_slo_s:.3g}s/tpot"
                                   f"{obj.tpot_slo_s:.3g}s")

    def replica(name="r0", warm_from=None):
        return t_fleet.PlannedReplica(
            pricer=t_fleet.compass_pricer(spec, hw, ga, objective=obj,
                                          n_blocks=2, warm_from=warm_from,
                                          device=CPU),
            scheduler="orca", max_slots=slots, max_iters=2048, name=name)

    for point in record["points"]:
        dec = t_fleet.plan_scale_out(
            t_fleet.Fleet([replica()]), base, point["rate"], objective=obj,
            re_search=lambda rep, res: replica(f"{rep.name}'",
                                               res.meta["search_output"]))
        assert dec.best.action == point["best_action"]
        assert dec.best.fleet.n_replicas == point["n_replicas"]
        assert dec.best.result.route.loads().tolist() == point["loads"]
        for got, want in zip(dec.options, point["options"], strict=True):
            assert got.action == want["action"]
            assert abs(got.score - want["goodput_per_dollar"]) <= 5.01e-7
