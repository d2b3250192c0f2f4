"""The port's serving engine (``repro_torch.serve``) beside the
reference's (``repro.serve``): the counterparts of the 14 cases of
``tests/test_serve.py``, each run on both sides where it serves tokens
(reduced olmo-1b in float32, the reference's params carried across with
``repro_torch.convert``, on the CPU), and ``cache_bytes`` over the ten
configs.

What is held:
  * every generated token equal to the reference engine's (float32; the
    decode steps agree within 1e-5, ``tests/test_torch_decode.py``);
  * the monitor's transitions, device states, watchdog and scale
    estimates identical (the same numpy code on both sides);
  * the online loop's events, swap kinds, steps and partitions, and the
    ``swaps``/``reverts``/``dropped`` counts equal (the sensitivity
    surrogate observes, numpy only);
  * the KV cache intact across a hot swap, and every other slot bitwise
    unchanged by an admission;
  * ``cache_bytes`` the reference's integer for all ten configs.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import graph as jgraph  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import graph as tgraph  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SIDES = ("ref", "port")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_LM = {}


def lm(side):
    """(cfg, params, libs) of reduced olmo-1b on one side; the port's
    params are the reference's, converted."""
    if not _LM:
        jcfg = jget("olmo-1b").reduced()
        jp = JT.init_lm(jcfg, jax.random.PRNGKey(0))
        _LM["ref"] = (jcfg, jp, types.SimpleNamespace(
            core=jcore, serve=jserve, graph=jgraph))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _LM["port"] = (get_config("olmo-1b").reduced(), tp,
                       types.SimpleNamespace(core=tcore, serve=tserve,
                                             graph=tgraph))
    return _LM[side]


def _mk_reqs(serve, cfg, lengths, max_new, seed=10):
    rng = np.random.default_rng(seed)
    return [serve.Request(uid=i,
                          prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                          max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


def _outs(reqs):
    return [r.out for r in sorted(reqs, key=lambda r: r.uid)]


def test_generate_batch():
    outs = {}
    for side in SIDES:
        cfg, params, lib = lm(side)
        eng = lib.serve.Engine(cfg, params, lib.serve.ServeConfig())
        rng = np.random.default_rng(0)
        reqs = [lib.serve.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
            max_new_tokens=5) for i in range(3)]
        out = eng.generate(reqs)
        assert all(r.done and len(r.out) == 5 for r in out)
        assert all(0 <= t < cfg.vocab for r in out for t in r.out)
        outs[side] = _outs(out)
    assert outs["port"] == outs["ref"]


def test_generation_deterministic():
    outs = {}
    for side in SIDES:
        cfg, params, lib = lm(side)
        prompt = np.random.default_rng(1).integers(0, cfg.vocab, 6) \
            .astype(np.int32)
        runs = []
        for _ in range(2):
            eng = lib.serve.Engine(cfg, params, lib.serve.ServeConfig())
            runs.append(eng.generate([lib.serve.Request(
                uid=0, prompt=prompt, max_new_tokens=6)])[0].out)
        assert runs[0] == runs[1]
        outs[side] = runs[0]
    assert outs["port"] == outs["ref"]


def test_greedy_matches_forward():
    """First generated token == argmax of the full forward's last logits,
    on both sides, and the same token."""
    firsts = {}
    for side in SIDES:
        cfg, params, lib = lm(side)
        prompt = np.random.default_rng(2).integers(0, cfg.vocab, 8) \
            .astype(np.int32)
        eng = lib.serve.Engine(cfg, params, lib.serve.ServeConfig())
        r = eng.generate([lib.serve.Request(uid=0, prompt=prompt,
                                            max_new_tokens=1)])[0]
        if side == "ref":
            logits = JT.forward(params, cfg, {"tokens": jnp.asarray(prompt)[None]})
            want = int(jnp.argmax(logits[0, -1]))
        else:
            with torch.no_grad():
                logits = T.forward(params, cfg,
                                   {"tokens": torch.from_numpy(prompt)[None]})
            want = int(torch.argmax(logits[0, -1]))
        assert r.out[0] == want
        firsts[side] = want
    assert firsts["port"] == firsts["ref"]


def _reconfig_run(side):
    cfg, params, lib = lm(side)
    C = lib.core
    layers = lib.graph.lm_layer_infos(cfg, seq=64)
    cm = C.CostModel(layers, C.POD_TIERS)
    ev = C.SurrogateAccuracyEvaluator(cm)
    part = C.AFarePart(layers, C.POD_TIERS, acc_evaluator=ev,
                       nsga2_config=C.NSGA2Config(population=16,
                                                  generations=6, seed=0))
    plan = part.optimize()

    def observe(partition, scales):
        old = cm.fault_scale.copy()
        cm.fault_scale = np.asarray(scales, float)
        v = float(cm.sensitivity_surrogate(partition[None, :])[0])
        cm.fault_scale = old
        return v

    env = C.FaultEnvironment(base_scale=np.array([1.0, 0.1]),
                             schedule={8: np.array([1.0, 40.0])})
    rec = C.OnlineReconfigurator(part, plan,
                                 theta=observe(plan.partition,
                                               env.base_scale) * 2 + 1e-9,
                                 observe_fn=observe, reopt_generations=4)

    def partition_to_rates(partition, scales):
        sc = np.asarray(scales if scales is not None else env.base_scale)
        r = 0.2 * sc[partition]
        return r.astype(np.float32), r.astype(np.float32)

    eng = lib.serve.Engine(cfg, params, lib.serve.ServeConfig(canary_every=4),
                           fault_env=env, reconfigurator=rec,
                           partition_to_rates=partition_to_rates)
    rng = np.random.default_rng(3)
    reqs = [lib.serve.Request(
        uid=i, prompt=rng.integers(0, cfg.vocab, 4).astype(np.int32),
        max_new_tokens=16) for i in range(2)]
    out = eng.generate(reqs)
    return out, rec, eng


def _swap_log(eng):
    return [(e["step"], e["kind"], e["pre_delta"], e["post_delta"],
             e["new_partition"].tolist()) for e in eng.swap_events]


def test_online_reconfig_in_serving():
    """The paper's online loop inside the engine, faulted decode steps
    included: the canary sees a glitching tier, NSGA-II re-runs, the
    deployed partition swaps, on both sides alike and with equal
    tokens."""
    runs = {side: _reconfig_run(side) for side in SIDES}
    for out, rec, eng in runs.values():
        assert all(r.done for r in out)
        assert len(rec.events) >= 1, "environment shift must trigger reconfig"
        assert eng.swap_events, "engine should record the hot swap"
    (jo, jr, je), (to, tr, te) = runs["ref"], runs["port"]
    assert _swap_log(te) == _swap_log(je)
    assert [(e.step, e.new_partition.tolist()) for e in tr.events] == \
        [(e.step, e.new_partition.tolist()) for e in jr.events]
    assert _outs(to) == _outs(jo)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_bytes_estimate(arch):
    """The reference's integer for every config; olmo-1b's in its range
    (16 layers x 2 (k+v) x 1024 x 16 kv x 128 hd x 2 bytes + pos)."""
    b = tserve.cache_bytes(get_config(arch), batch=1, max_len=1024)
    assert b == jserve.cache_bytes(jget(arch), batch=1, max_len=1024)
    if arch == "olmo-1b":
        assert 100e6 < b < 300e6
    specs = tserve.cache_specs(get_config(arch), 2, 64)
    want = jserve.cache_specs(jget(arch), 2, 64)
    assert {k: {n: (tuple(t.shape), str(t.dtype)) for n, t in v.items()}
            for k, v in specs.items()} == \
        {k: {n: (tuple(t.shape), "torch." + t.dtype.name)
             for n, t in v.items()} for k, v in want.items()}
    assert all(t.device.type == "meta" for t in tree_leaves(specs))


# -- continuous batching ----------------------------------------------------

def test_mixed_length_admission():
    """Admission/retirement under mixed prompt lengths with queue
    pressure: every request completes with the right token count and no
    drops, each request's tokens are independent of which other requests
    share the batch, and equal to the reference's."""
    lengths = [3, 5, 8, 9, 4]
    max_new = [4, 7, 3, 5, 6]
    outs = {}
    for side in SIDES:
        cfg, params, lib = lm(side)
        eng2 = lib.serve.Engine(cfg, params,
                                lib.serve.ServeConfig(max_batch=2, max_len=32))
        out2 = eng2.generate(_mk_reqs(lib.serve, cfg, lengths, max_new))
        assert all(r.done and len(r.out) == m for r, m in zip(out2, max_new))
        s = eng2.stats()
        assert s["dropped"] == 0 and s["completed"] == 5
        assert s["max_queue_depth"] >= 1, "max_batch=2 must queue 5 requests"
        eng4 = lib.serve.Engine(cfg, params,
                                lib.serve.ServeConfig(max_batch=4, max_len=32))
        out4 = eng4.generate(_mk_reqs(lib.serve, cfg, lengths, max_new))
        for a, b in zip(out2, out4):
            assert a.out == b.out, "tokens must not depend on batch sharing"
        outs[side] = _outs(out2)
    assert outs["port"] == outs["ref"]


def test_merge_slot_leaves_other_slots_bitwise():
    """An admission writes one slot of every leaf, in place; the other
    slots' bytes do not change."""
    cfg, params, _ = lm("port")
    full = T.init_cache(cfg, 3, 32, device="cpu")
    for t in tree_leaves(full):
        t.copy_(torch.randn(t.shape).to(t.dtype) if t.is_floating_point()
                else torch.randint(-1, 32, t.shape, dtype=t.dtype))
    before = [t.clone() for t in tree_leaves(full)]
    with torch.no_grad():
        _, one = T.prefill(params, cfg, {"tokens": torch.arange(8)[None]},
                           max_len=32)
    assert tserve.merge_slot(full, one, 1) is full
    for b, a, o in zip(before, tree_leaves(full), tree_leaves(one)):
        assert torch.equal(a[:, [0, 2]], b[:, [0, 2]])
        assert torch.equal(a[:, 1], o[:, 0])


def test_early_exit_no_extra_decode_steps():
    """The engine stops decoding the moment the last request retires."""
    cfg, params, lib = lm("port")
    eng = lib.serve.Engine(cfg, params,
                           lib.serve.ServeConfig(max_batch=4, max_len=32))
    eng.generate(_mk_reqs(lib.serve, cfg, [4], [5]))
    # first token comes from prefill, so 5 tokens need only 4 decode steps
    assert eng.stats()["decode_steps"] == 4
    eng1 = lib.serve.Engine(cfg, params,
                            lib.serve.ServeConfig(max_batch=4, max_len=32))
    eng1.generate(_mk_reqs(lib.serve, cfg, [4], [1]))
    assert eng1.stats()["decode_steps"] == 0


def test_kv_integrity_across_hot_swap():
    """A hot swap must not disturb in-flight KV state: with all-zero
    fault rates on every tier a mid-stream swap is token-identical to a
    run that never swaps (the rate-0 steps fake-quantize, on both
    sides)."""
    outs = {}
    for side in SIDES:
        cfg, params, lib = lm(side)

        def zero_rates(partition, scales):
            z = np.zeros(cfg.n_layers, np.float32)
            return z, z

        p0 = np.zeros(cfg.n_layers, np.int64)
        p1 = np.ones(cfg.n_layers, np.int64)

        def run(swap_at):
            eng = lib.serve.Engine(
                cfg, params, lib.serve.ServeConfig(max_batch=4, max_len=64),
                partition_to_rates=zero_rates)
            eng.apply_partition(p0)
            for r in _mk_reqs(lib.serve, cfg, [6, 8], [12, 12], seed=11):
                eng.submit(r)
            for _ in range(swap_at):
                eng.step()
            if swap_at:
                eng.apply_partition(p1)
            eng.run()
            return _outs(eng.completed)

        outs[side] = run(swap_at=5)
        assert outs[side] == run(swap_at=0)
    assert outs["port"] == outs["ref"]


def test_slo_accounting():
    cfg, params, lib = lm("port")
    eng = lib.serve.Engine(cfg, params,
                           lib.serve.ServeConfig(max_batch=2, max_len=32))
    out = eng.generate(_mk_reqs(lib.serve, cfg, [4, 6, 5], [6, 6, 6]))
    for r in out:
        assert r.submit_s <= r.admit_s <= r.first_token_s <= r.finish_s
        assert r.ttft_s > 0 and r.tpot_s >= 0
    s = eng.stats()
    want = jserve.Engine(*lm("ref")[:2], jserve.ServeConfig()).stats()
    assert sorted(s) == sorted(want)
    assert s["dropped"] == 0 and s["ttft_s_mean"] > 0


def test_pipeline_stages_records_swap_migration():
    """``ServeConfig(pipeline_stages=2)``: each hot swap after the first
    records which layer groups change pipeline stage, as the reference's
    engine does, on a 4-layer reduced olmo-1b serving the same trace."""
    import dataclasses

    swaps = [np.zeros(4, np.int64), np.array([0, 0, 0, 1]),
             np.array([0, 1, 1, 1])]
    events = {}
    for side in SIDES:
        _, _, lib = lm(side)
        if side == "ref":
            cfg = dataclasses.replace(jget("olmo-1b").reduced(), n_layers=4)
            params = JT.init_lm(cfg, jax.random.PRNGKey(1))
        else:
            cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                                      n_layers=4)
            params = convert.params_from_jax(
                jax.tree.map(np.asarray, JT.init_lm(
                    dataclasses.replace(jget("olmo-1b").reduced(),
                                        n_layers=4),
                    jax.random.PRNGKey(1))), device="cpu")

        def zero_rates(partition, scales):
            z = np.zeros(4, np.float32)
            return z, z

        eng = lib.serve.Engine(
            cfg, params, lib.serve.ServeConfig(max_batch=2, max_len=32,
                                               pipeline_stages=2),
            partition_to_rates=zero_rates)
        for r in _mk_reqs(lib.serve, cfg, [4, 6], [6, 6], seed=12):
            eng.submit(r)
        for part in swaps:
            eng.apply_partition(part)
            eng.step()
        eng.run()
        events[side] = eng.swap_events
    for side in SIDES:
        assert "migration" not in events[side][0]
    got = [e["migration"] for e in events["port"][1:]]
    assert got == [e["migration"] for e in events["ref"][1:]]
    assert [m["migrated_groups"] for m in got] == [1, 2]


def test_sharded_cache_specs_need_launch():
    """``seq_shards`` 1 is the whole cache; ``n`` shards divide every
    attention cache's sequence dimension by ``n`` (the reference's local
    shard shapes), and a count that does not divide raises."""
    for arch in ("olmo-1b", "gemma2-27b", "recurrentgemma-2b"):
        cfg, jcfg = get_config(arch).reduced(), jget(arch).reduced()
        assert tserve.cache_specs(cfg, 2, 64, seq_shards=1).keys() == \
            tserve.cache_specs(cfg, 2, 64).keys()
        got = tserve.cache_specs(cfg, 2, 64, seq_shards=2)
        want = jserve.cache_specs(jcfg, 2, 64, seq_shards=2)
        for slot, entry in want.items():
            for name, w in entry.items():
                assert tuple(got[slot][name].shape) == w.shape, (arch, name)
        with pytest.raises(ValueError, match="do not split"):
            tserve.cache_specs(cfg, 2, 64, seq_shards=3)


# -- fault monitor ----------------------------------------------------------

def _mcfg(serve, **kw):
    base = dict(base_error_rate=1.0, ewma_alpha=1.0, scale_quantum=0.25,
                degraded_factor=4.0, critical_factor=16.0,
                recovery_ticks=2, watchdog_timeout_ticks=1000)
    base.update(kw)
    return serve.MonitorConfig(**base)


def _monitor_view(mon):
    return ([(t, d, a.name, b.name) for t, d, a, b in mon.transitions],
            [s.name for s in mon.device_states()], mon.state.name,
            mon.estimated_scales().tolist(), mon.stats())


@pytest.mark.parametrize("side", SIDES)
def test_monitor_state_machine_transitions(side):
    serve = lm(side)[2].serve
    H = serve.HealthState
    mon = serve.FaultMonitor(np.array([1.0, 1.0]), _mcfg(serve))
    seen = []
    for counts, state in (([1.0, 1.0], H.HEALTHY), ([5.0, 1.0], H.DEGRADED),
                          ([20.0, 1.0], H.CRITICAL),
                          # recovery needs `recovery_ticks` calm ticks
                          ([1.0, 1.0], H.CRITICAL), ([1.0, 1.0], H.HEALTHY)):
        mon.heartbeat()
        mon.observe_errors(counts)
        assert mon.tick() == state
        seen.append(_monitor_view(mon))
    assert len(mon.transitions) == 3
    if side == "port":
        ref = jserve.FaultMonitor(np.array([1.0, 1.0]), _mcfg(jserve))
        for counts, view in zip(([1.0, 1.0], [5.0, 1.0], [20.0, 1.0],
                                 [1.0, 1.0], [1.0, 1.0]), seen):
            ref.heartbeat()
            ref.observe_errors(counts)
            ref.tick()
            assert _monitor_view(ref) == view


def test_monitor_watchdog_presumes_dead():
    views = {}
    for side in SIDES:
        serve = lm(side)[2].serve
        mon = serve.FaultMonitor(np.array([1.0, 1.0]),
                                 _mcfg(serve, watchdog_timeout_ticks=3))
        for _ in range(5):
            mon.heartbeat(device=0)               # device 1 goes silent
            mon.observe_errors([1.0, 1.0])
            state = mon.tick()
        assert state == serve.HealthState.CRITICAL
        assert mon.device_states()[0] == serve.HealthState.HEALTHY
        assert mon.device_states()[1] == serve.HealthState.CRITICAL
        views[side] = _monitor_view(mon)
    assert views["port"] == views["ref"]


def test_monitor_estimates_scales_exactly():
    """With alpha=1 and exact expected counts, the EWMA estimate
    reproduces the true environment scales bitwise."""
    true = np.array([1.0, 32.0])
    views = {}
    for side in SIDES:
        serve = lm(side)[2].serve
        mon = serve.FaultMonitor(np.array([1.0, 0.25]),
                                 _mcfg(serve, base_error_rate=0.25))
        mon.heartbeat()
        mon.observe_errors(0.25 * true)
        mon.tick()
        assert np.array_equal(mon.estimated_scales(), true)
        views[side] = _monitor_view(mon)
    assert views["port"] == views["ref"]


# -- telemetry-fed reconfiguration ------------------------------------------

def _surrogate_setup(lib, seed=0):
    C = lib.core
    cfg = (jget if lib.core is jcore else get_config)("olmo-1b").reduced()
    layers = lib.graph.lm_layer_infos(cfg, seq=64)
    cm = C.CostModel(layers, C.POD_TIERS)
    ev = C.SurrogateAccuracyEvaluator(cm)
    part = C.AFarePart(layers, C.POD_TIERS, acc_evaluator=ev,
                       nsga2_config=C.NSGA2Config(population=16,
                                                  generations=6, seed=seed))
    plan = part.optimize()

    def observe(partition, scales):
        old = cm.fault_scale.copy()
        cm.fault_scale = np.asarray(scales, float)
        v = float(cm.sensitivity_surrogate(partition[None, :])[0])
        cm.fault_scale = old
        return v

    return part, plan, observe


def _events(rec):
    return [(e.step, e.new_partition.tolist(), e.observed_delta_acc)
            for e in rec.events]


def test_telemetry_matches_oracle():
    """The monitor-fed loop makes the same reconfiguration decisions as
    oracle-fed ``simulate_deployment`` when the estimates are exact, and
    the port's decisions are the reference's."""
    logs = {}
    for side in SIDES:
        lib = lm(side)[2]
        C = lib.core
        env = C.FaultEnvironment(base_scale=np.array([1.0, 0.25]),
                                 schedule={3: np.array([1.0, 32.0])})
        part_a, plan_a, obs_a = _surrogate_setup(lib)
        theta = obs_a(plan_a.partition, env.base_scale) * 1.5 + 1e-9
        rec_a = C.OnlineReconfigurator(part_a, plan_a, theta=theta,
                                       observe_fn=obs_a, reopt_generations=4)
        log = C.simulate_deployment(rec_a, env, n_steps=6)
        part_b, plan_b, obs_b = _surrogate_setup(lib)
        rec_b = C.OnlineReconfigurator(part_b, plan_b, theta=theta,
                                       observe_fn=obs_b, reopt_generations=4)
        mon = lib.serve.FaultMonitor(env.base_scale,
                                     _mcfg(lib.serve, base_error_rate=0.25))
        for t in range(6):
            mon.heartbeat()
            mon.observe_errors(0.25 * env.scales_at(t))   # exact expectation
            mon.tick()
            rec_b.step(t, mon.estimated_scales())
        assert len(log["events"]) >= 1
        assert _events(rec_b) == _events(rec_a)
        logs[side] = _events(rec_b)
    assert logs["port"] == logs["ref"]


def test_critical_reverts_to_last_safe():
    """CRITICAL falls back to the last-known-safe partition immediately
    (before re-optimization completes) and abandons the stale job; the
    port's swaps, reverts, tokens and monitor equal the reference's."""
    runs = {}
    for side in SIDES:
        cfg, params, lib = lm(side)
        part, plan, observe = _surrogate_setup(lib)
        base = np.array([1.0, 0.25])
        theta = observe(plan.partition, base) * 1.1 + 1e-9
        rec = lib.core.OnlineReconfigurator(part, plan, theta=theta,
                                            observe_fn=observe,
                                            reopt_generations=2)
        mon = lib.serve.FaultMonitor(base,
                                     _mcfg(lib.serve, base_error_rate=0.25))

        def errors(tick):
            # healthy -> device 1 degraded (ratio 8) -> device 1 critical
            scale1 = 0.25 if tick <= 3 else (2.0 if tick <= 12 else 32.0)
            return 0.25 * np.array([1.0, scale1])

        def partition_to_rates(partition, scales):
            r = 0.2 * np.asarray(scales)[partition]
            return r.astype(np.float32), r.astype(np.float32)

        eng = lib.serve.Engine(cfg, params, lib.serve.ServeConfig(
            max_batch=4, max_len=64, canary_every=2),
            reconfigurator=rec, partition_to_rates=partition_to_rates,
            monitor=mon, error_source=errors)
        p0 = plan.partition.copy()
        out = eng.generate(_mk_reqs(lib.serve, cfg, [4, 6], [24, 24],
                                    seed=12))
        assert all(r.done for r in out)
        kinds = [e["kind"] for e in eng.swap_events]
        assert "reopt" in kinds, "degraded phase should re-optimize and swap"
        assert "revert" in kinds, "critical phase should revert immediately"
        first_revert = kinds.index("revert")
        assert kinds.index("reopt") < first_revert
        assert np.array_equal(eng.swap_events[first_revert]["new_partition"],
                              p0)
        s = eng.stats()
        assert s["dropped"] == 0
        runs[side] = (_swap_log(eng), s["swaps"], s["reverts"], _outs(out),
                      _monitor_view(mon))
    assert runs["port"] == runs["ref"]


def test_engine_runs_on_the_params_device():
    cfg, params, lib = lm("port")
    eng = lib.serve.Engine(cfg, params,
                           lib.serve.ServeConfig(max_batch=2, max_len=16))
    assert eng.device == torch.device("cpu")
    eng.generate(_mk_reqs(lib.serve, cfg, [3], [2]))
    assert all(t.device.type == "cpu" for t in tree_leaves(eng._cache))
