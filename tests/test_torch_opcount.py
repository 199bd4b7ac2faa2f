"""The port's op model (``ops/opcount.py``) against the reference's
(``corda_tpu/ops/opcount.py``), its integer counts pinned to the port's
kernel modules, and the profiler's roofline fields derived from it.

Every comparison is exact equality. The ``muls``/``sqs`` census equals the
reference's where kernel B and G run the reference's formulas and addition
chains (ed25519, both radices, both fixed-base shapes, with and without the
chains). Kernel F's differs from the reference's census, and the test pins
the port's count to the plain ladder that runs kernel F's formulas:

- secp256r1: the reference counts its 1,100 multiplications by a = -3 as
  field multiplies; kernel F does each as three adds (``mul_a``);
- secp256k1: one multiply fewer: the on-curve check's x^3 is one squaring
  and one multiply in kernel F, where the reference's census adds a second
  multiply beside its squarings.
"""

import pytest
import torch

from corda_tpu.ops import opcount as ref_opcount
from corda_tpu_torch.observability.profiler import DeviceProfiler
from corda_tpu_torch.ops import ed25519_ladder4096 as g
from corda_tpu_torch.ops import opcount
from corda_tpu_torch.ops import secp256_ladder as f


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("radix", [8192, 4096])
@pytest.mark.parametrize("fixed_win", [8, 4])
@pytest.mark.parametrize("chains", [True, False])
def test_ed25519_census_is_the_references(radix, fixed_win, chains):
    ref = ref_opcount.ops_per_verify(ref_opcount.ed25519_config(radix, fixed_win, chains))
    port = opcount.ops_per_verify(opcount.ed25519_config(radix, fixed_win, chains))
    assert (port["muls"], port["sqs"]) == (ref["muls"], ref["sqs"])
    assert "macs" not in port
    assert set(port) == set(ref) - {"macs"}


@pytest.mark.parametrize("fixed_win", [8, 4])
def test_ed25519_ops_are_the_kernels(fixed_win):
    """B's count is its field operations on ref10's limbs; G's is the census
    its plain ladder counts, on eight words with its adds and compares."""
    b = opcount.ops_per_verify(opcount.ed25519_config(8192, fixed_win))
    assert b["ops"] == opcount.ladder_int_ops(fixed_win) == (
        b["muls"] * opcount.INT_OPS_PER_FIELD_MUL + b["sqs"] * opcount.INT_OPS_PER_FIELD_SQ)
    assert (b["mul_ops"], b["sq_ops"]) == (214, 123)
    counted = g.field_ops_per_verify(fixed_win)
    assert {k: counted[k] for k in ("mul", "sq")} == opcount.ed25519_field_ops(fixed_win)
    gg = opcount.ops_per_verify(opcount.ed25519_config(4096, fixed_win))
    assert gg["ops"] == opcount.g_int_ops(fixed_win) == (
        counted["mul"] * (128 + 44) + counted["sq"] * (88 + 44) + counted["add"] * 24
        + counted["eq"] * 16)


def test_ecdsa_census_pinned_to_kernel_f():
    for curve, ref_extra_muls in (("secp256k1", 1), ("secp256r1", 1100)):
        counted = f.field_ops_per_verify(curve)
        port = opcount.ops_per_verify(opcount.ecdsa_config(curve))
        ref = ref_opcount.ops_per_verify(ref_opcount.ecdsa_config(curve, 4096, 8))
        assert port["muls"] == counted["mul"] + counted["mul_b3"]
        assert port["sqs"] == counted["sq"] == ref["sqs"]
        assert ref["muls"] - port["muls"] == ref_extra_muls
        assert port["ops"] == opcount.ecdsa_int_ops(curve)
    # a = -3 costs r1 its multiplies by a as three adds each
    k1, r1 = f.field_ops_per_verify("secp256k1"), f.field_ops_per_verify("secp256r1")
    assert r1["add"] - k1["add"] > 0 and (r1["mul"], r1["sq"]) == (k1["mul"], k1["sq"])
    assert opcount.ecdsa_config("secp256r1")["radix"] == 2**32
    with pytest.raises(ValueError):
        opcount.ecdsa_config("ed25519")


@pytest.mark.parametrize("n", [8, 64, 256])
def test_rlc_model_is_the_references(n):
    assert opcount.rlc_config(n) == ref_opcount.rlc_config(n)
    assert opcount.rlc_ops_per_batch(opcount.rlc_config(n)) == \
        ref_opcount.rlc_ops_per_batch(ref_opcount.rlc_config(n))
    assert opcount.rlc_ops_per_verify(opcount.rlc_config(n)) == \
        ref_opcount.rlc_ops_per_verify(ref_opcount.rlc_config(n))


def test_active_models_keys_and_default_tier():
    ref, port = ref_opcount.active_models(), opcount.active_models()
    assert set(port) == set(ref)
    for name in ("ed25519", "ecdsa"):
        assert set(port[name]) == set(ref[name]) - {"macs_per_verify"}
    assert port["ed25519"]["config"] == ref["ed25519"]["config"]
    assert port["ed25519"]["field_muls_per_verify"] == ref["ed25519"]["field_muls_per_verify"]
    assert port["ed25519"]["ops_per_verify"] == opcount.ladder_int_ops(8)
    assert port["ed25519_batch"] == ref["ed25519_batch"]


def test_kernel_counts_are_the_kernels_shapes():
    """One figure a kernel A-H, each from the parameters it describes."""
    from corda_tpu_torch.ops import ed25519_sign, scalar25519

    ops = opcount.kernel_int_ops()
    assert sorted(ops) == ["A", "B", "C", "D", "E", "F-k1", "F-r1", "G", "H"]
    assert ops["A"] == 4240 and opcount.CHALLENGE_ROUNDS_WARP_OPS == 2960
    assert scalar25519.WINDOWS == 64
    assert (ops["C"], ops["D"], opcount.INT_OPS_ROUNDS_PER_BLOCK) == (1384, 2288, 904)
    comb = opcount.comb_field_ops()
    assert comb == {"mul": ed25519_sign.WINDOWS * 7 + 11 + 2, "sq": 254}
    assert ops["E"] == comb["mul"] * 214 + comb["sq"] * 123 + 64 * 16 * 3 * 10
    assert ops["B"] == opcount.ladder_int_ops(8) and ops["G"] == opcount.g_int_ops(8)
    assert ops["F-r1"] > ops["F-k1"] > 0
    assert ops["H"] % opcount.INT_OPS_PER_BLOCK == 0 and ops["H"] > ops["F-r1"]
    assert opcount.statestore_int_ops(10, 32) == 10 * 32 * 12


def test_sphincs_counts_follow_the_digits():
    from corda_tpu_torch.crypto.sphincs import D, N

    low = [bytes(N)] * D                     # every digit 0: the longest chains
    high = [b"\xff" * N] * D
    blocks_low, chain_low = opcount.sphincs_lane_work(low)
    blocks_high, chain_high = opcount.sphincs_lane_work(high)
    # the checksum digits of an all-0xff digest are low, so its longest
    # chain is as long as the all-zero digest's
    assert blocks_low > blocks_high and chain_low == chain_high
    assert opcount.sphincs_chain_ops(low, 5) == opcount.sphincs_chain_ops(high, 5) > 0
    # an auth level at an odd position hoists its first block whole
    assert opcount.sphincs_chain_ops(low, 0) > opcount.sphincs_chain_ops(low, 63)


def test_bound_rule_and_data_sheet_rates():
    assert opcount.H100_INT32_OPS_PER_S == 64 * 132 * 1980e6
    ms, by = opcount.bound(3.35e12, 0)
    assert (ms, by) == (1000.0, "bytes")
    ms, by = opcount.bound(0, opcount.H100_INT32_OPS_PER_S)
    assert (ms, by) == (1000.0, "operations")
    assert opcount.serial_floor_ms(1980, 1980.0) == pytest.approx(32 / 16 / 1e3)


def test_roofline_rows_from_the_model():
    table = {k: opcount.roofline_rows_per_sec(k) for k in opcount._roofline_rows()}
    assert set(table) == {"ed25519.verify", "sha512", "ed25519.sign", "ecdsa.verify",
                          "sha256", "txid"}
    ops = opcount.kernel_int_ops()
    # the verify is bound by its operations: A then B's comb a row
    assert table["ed25519.verify"] == pytest.approx(
        opcount.H100_INT32_OPS_PER_S / (ops["A"] + ops["B"]))
    assert table["sha512"] > table["ed25519.verify"]
    assert opcount.roofline_rows_per_sec("sphincs.verify") is None
    assert opcount.roofline_rows_per_sec("host_ref") is None


def test_profiler_snapshot_carries_the_roofline():
    prof = DeviceProfiler(enabled=True)
    for kernel in ("ed25519.verify", "sha512", "sphincs.verify"):
        prof.profile(kernel, lambda: None, rows=8, bucket=8)
        prof.profile(kernel, lambda: sum(range(1000)), rows=8, bucket=8)
    snap = prof.snapshot()["kernels"]
    for kernel in ("ed25519.verify", "sha512"):
        agg = snap[kernel]
        assert agg["roofline_rows_per_sec"] == round(opcount.roofline_rows_per_sec(kernel), 1)
        assert agg["roofline_frac"] == round(agg["rows_per_sec"] / opcount.roofline_rows_per_sec(
            kernel), 4)
    assert "roofline_rows_per_sec" not in snap["sphincs.verify"]
