"""The traffic generator: a seed gives the same traffic, every seed the
same set of sizes, lengths within their ranges, sessions that share
their prefixes."""

import collections

from port_bench import harness, traffic

from .tiny import MIX

#: the mixes the benchmark's cells name
MIXES = sorted({w["traffic"] for w in harness.spec()["workloads"]})


def _mix(name):
    return traffic.load(name)


def _drain(mix, seed, n, answer=7):
    """The first ``n`` sessions' prompts, each turn answered with
    ``answer`` repeated."""
    tr = traffic.Traffic(mix, seed, 1000)
    out = []
    for _ in range(n):
        s = tr.next_session()
        turns = []
        while True:
            p = s.prompt(tr.vocab)
            turns.append((p, s.max_new()))
            if not s.answered(p, [answer] * s.max_new()):
                break
        out.append((s.shape, turns))
    return out


def test_same_seed_same_traffic():
    for name in MIXES:
        mix = _mix(name)
        assert _drain(mix, 2 ** 31 + 3, 20) == _drain(mix, 2 ** 31 + 3, 20)
        assert _drain(mix, 2 ** 31 + 3, 4) != _drain(mix, 2 ** 31 + 5, 4)


def test_lengths_in_range_and_the_same_set_for_every_seed():
    for name in MIXES:
        mix = _mix(name)
        n = mix["pool"]
        sizes = []
        for seed in (1, 2 ** 33 + 7):
            got = _drain(mix, seed, n)
            sizes.append(collections.Counter(shape for shape, _ in got))
            for shape, turns in got:
                lo, hi = mix["turns"]
                assert lo <= len(turns) <= hi
                for (user, out), (_, max_new) in zip(shape.turns, turns):
                    assert mix["prompt_tokens"]["min"] <= user \
                        <= mix["prompt_tokens"]["max"]
                    assert mix["output_tokens"]["min"] <= out \
                        <= mix["output_tokens"]["max"] and max_new == out
        assert sizes[0] == sizes[1]  # a permutation of one pool


def test_quantiles_cover_the_range():
    u = {"dist": "uniform", "min": 16, "max": 64}
    vals = sorted(traffic.quantile(u, x) for x in traffic.grid(49, 0))
    assert vals == list(range(16, 65))


def test_log_normal_lengths_keep_the_median_and_the_clip():
    d = {"dist": "log_normal", "median": 129, "sigma": 0.992, "min": 2,
         "max": 2048}
    vals = sorted(traffic.quantile(d, u) for u in traffic.grid(33, 0))
    assert vals[16] == 129
    # the mean of a log-normal is median * exp(sigma^2 / 2) = 211
    assert 190 < sum(vals) / len(vals) < 215
    assert traffic.quantile(d, 1e-9) == 2
    assert traffic.quantile(d, 1 - 1e-12) == 2048


def test_extent_spans_the_pool():
    mix = _mix("chat-sessions")
    lo, hi = traffic.extent(mix)
    firsts, ends = [], []
    for shape in traffic.pool(mix):
        firsts.append(mix["system_tokens"] + shape.turns[0][0])
        ends.append(mix["system_tokens"] + sum(u + o for u, o in shape.turns))
    assert (lo, hi) == (min(firsts), max(ends))


def test_sessions_share_their_prefixes():
    mix = _mix("chat-sessions")
    got = _drain(mix, 77, mix["pool"])
    systems = collections.Counter()
    for shape, turns in got:
        first = turns[0][0]
        systems[tuple(first[:mix["system_tokens"]])] += 1
        for (p, n), (q, _) in zip(turns, turns[1:]):
            # the next turn resends the history and the answer
            assert q[:len(p) + n] == p + [7] * n
            assert len(q) > len(p) + n
    assert len(systems) == mix["system_prompts"]
    assert max(systems.values()) > 1


def test_tiny_mix_single_turns_have_no_system_prompt():
    mix = dict(MIX, turns=[1, 1], system_prompts=0, system_tokens=0)
    for shape, turns in _drain(mix, 5, 6):
        assert shape.system is None and len(turns) == 1


def test_every_seed_runs_the_same_schedule():
    """Seeds change the token ids, never the sizes or their order."""
    for name in MIXES:
        mix = _mix(name)
        a = _drain(mix, 3, mix["pool"] + 3)
        b = _drain(mix, 2 ** 40 + 9, mix["pool"] + 3)
        assert [s for s, _ in a] == [s for s, _ in b]
        assert [t for _, t in a] != [t for _, t in b]
