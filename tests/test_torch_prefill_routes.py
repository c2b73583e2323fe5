"""The port's chunked prefill and prefix radix cache against the reference
Engine on the same W8A8 weights, bf16 and int8 KV, in the f32 and bf16
compute dtypes, block-native decode without the kernel:
  * chunked: ``prefill_chunk`` 8 over the fused bucket 8, so the 20- and
    12-token prompts admit by the chunked scan;
  * prefix hot and cold: every prompt opens with the same 16-token preamble
    (two blocks of 8); the hot engine keeps the prefix cache (hits, a
    copy-on-write fork of a mid-block divergence, a full-prompt match), the
    cold one does not.
Rule and tolerances: tests/_torch_parity.py; the prefix counters (hits,
blocks and positions reused, chunks computed) are identical too.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
import _torch_parity as P  # noqa: E402

NATIVE = {"cache_backend": "paged", "paged_native": True}
CHUNK_PROMPTS, CHUNK_GENS = P.traffic([5, 20, 12, 7], 20, seed=3)
_pre, _ = P.traffic([24, 21], 24, seed=5, preamble=16)
PREFIX_PROMPTS = [_pre[0], _pre[0][:20].copy(), _pre[1], _pre[0][:16].copy()]
PREFIX_GENS = [24, 20, 24, 24]
CASES = {}
for kv in P.KV_DTYPES:
    CASES[f"chunked-{kv}"] = ({**NATIVE, "buckets": (8,), "prefill_chunk": 8}, kv,
                              CHUNK_PROMPTS, CHUNK_GENS)
    for mode, on in (("hot", True), ("cold", False)):
        CASES[f"prefix_{mode}-{kv}"] = ({**NATIVE, "prefix_cache": on}, kv,
                                        PREFIX_PROMPTS, PREFIX_GENS)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    return P.reference_in_subprocess(__file__, tmp_path_factory.mktemp("ref") / "prefill.pkl")


@pytest.fixture(scope="module")
def params(references):
    from repro_torch.testing.params import params_from_numpy
    return params_from_numpy(references["params"], device="cpu")


@pytest.fixture(scope="module")
def ports(params):
    return {(name, dt): P.run_port(params, name, case, dt)
            for name, case in CASES.items() for dt in P.DTYPES}


@pytest.mark.parametrize("dtype", P.DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_route_matches_reference(references, ports, name, dtype):
    ref, got = references[name, dtype], ports[name, dtype]
    P.check_tokens(ref, got, dtype, name)
    assert got["flags"] == ref["flags"]
    assert got["census"] == ref["census"]
    assert got["census"][-1]["referenced"] == []
    assert got["prefix"] == ref["prefix"]


@pytest.mark.parametrize("kv", P.KV_DTYPES)
@pytest.mark.parametrize("dtype", P.DTYPES)
def test_prefix_hot_equals_cold_and_counts(ports, kv, dtype):
    hot, cold = ports[f"prefix_hot-{kv}", dtype], ports[f"prefix_cold-{kv}", dtype]
    assert hot["tokens"] == cold["tokens"]
    s = hot["stats"]
    assert s["prefix_hits"] == 3 and s["cache"]["cow_forks"] == 1
    assert any(f.startswith("prefill_prefix/") for f in hot["flags"])


@pytest.mark.parametrize("kv", P.KV_DTYPES)
@pytest.mark.parametrize("dtype", P.DTYPES)
def test_chunked_admits_past_the_fused_bucket(ports, kv, dtype):
    flags = ports[f"chunked-{kv}", dtype]["flags"]
    assert flags["prefill_chunked/24"] == 1 and flags["prefill_chunked/16"] == 1
    assert np.all([len(t) == g for t, g in zip(ports[f"chunked-{kv}", dtype]["tokens"],
                                               CHUNK_GENS)])


if __name__ == "__main__":
    P.main(CASES)
