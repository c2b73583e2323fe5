"""Every SlotStore route of the port's Engine against the reference Engine
on the same W8A8 weights, staggered traffic, bf16 and int8 KV, in the f32
and bf16 compute dtypes: the contiguous store, the paged gather bridge,
block-native decode without the kernel and through the paged-attention
kernel (the reference's Pallas kernel in interpret mode; the port's
wrapper takes its plain version on the CPU; int8 KV attends by the plain
contraction on both sides). Rule and tolerances: tests/_torch_parity.py.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
import _torch_parity as P  # noqa: E402

ROUTES = {
    "contiguous": {"cache_backend": "contiguous"},
    "bridge": {"cache_backend": "paged"},
    "native_plain": {"cache_backend": "paged", "paged_native": True},
    "native_kernel": {"cache_backend": "paged", "paged_native": True, "paged_kernel": True},
}
PROMPTS, GENS = P.traffic([5, 9, 12, 7], 24)
CASES = {f"{route}-{kv}": (ecfg, kv, PROMPTS, GENS)
         for route, ecfg in ROUTES.items() for kv in P.KV_DTYPES}


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    return P.reference_in_subprocess(__file__, tmp_path_factory.mktemp("ref") / "routes.pkl")


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
def test_route_tokens_flags_and_census_match_reference(references, ports, name, dtype):
    ref, got = references[name, dtype], ports[name, dtype]
    P.check_tokens(ref, got, dtype, name)
    assert got["flags"] == ref["flags"]
    assert got["census"] == ref["census"]
    if ref["census"]:
        assert got["census"][-1]["referenced"] == []


@pytest.mark.parametrize("kv", P.KV_DTYPES)
@pytest.mark.parametrize("dtype", P.DTYPES)
def test_routes_bit_identical_within_the_port(ports, kv, dtype):
    """contiguous == bridge == native-plain tokens inside the port; the
    kernel route is held to the reference above (online softmax)."""
    toks = {r: ports[f"{r}-{kv}", dtype]["tokens"] for r in ROUTES}
    assert toks["bridge"] == toks["contiguous"] == toks["native_plain"]
    if kv == "int8":                  # int8 KV attends by the plain contraction
        assert toks["native_kernel"] == toks["native_plain"]


if __name__ == "__main__":
    P.main(CASES)
