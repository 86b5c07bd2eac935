"""The wide-width Pareto study's entry point
(``repro_torch.launch.wide_pareto.run``) end to end on the CPU, at its
smallest size: one eval image, the case-study picks plus two composed
recipes (exact 16- and 12-bit tiles), the fused datapath's plain
versions.  Both of the study's gates must hold (banked mixed-width
accuracies equal the sequential ones; a wide point beats every 8-bit
point's logit fidelity within the bound)."""
import pytest

from repro_torch.launch import wide_pareto
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_wide_pareto_small_run(monkeypatch):
    monkeypatch.setattr(wide_pareto, "WIDE_RECIPES",
                        (("mul8u_exact", 16, "loa4"),
                         ("mul8u_exact", 12, "loa4")))
    rec = wide_pareto.run("cpu", eval_n=1, batch=1, n_mult=1,
                          log=lambda s: None)
    assert rec["device"] == "cpu" and rec["variant"] == "fused"
    assert [c["bit_width"] for c in rec["candidates"]] == [8, 8, 8, 8, 16,
                                                           12]
    assert rec["mixed_bit_identical"] and rec["wide_bit_identical"]
    assert set(rec["wide_beyond_8bit_fidelity"]) == {
        "mul16u_c_mul8u_exact_loa4", "mul12u_c_mul8u_exact_loa4"}
    fid = {p["multiplier"]: p["logit_mae_vs_f32"] for p in rec["sweep"]}
    # 16-bit codes track the f32 model closer than 12-bit, 12 than 8
    assert (fid["mul16u_c_mul8u_exact_loa4"]
            < fid["mul12u_c_mul8u_exact_loa4"] < fid["mul8u_exact"])
    rp = {c["multiplier"]: c["rel_power_vs_mul8u_exact"]
          for c in rec["candidates"]}
    assert rp["mul8u_exact"] == 1.0
    assert rp["mul16u_c_mul8u_exact_loa4"] > rp["mul12u_c_mul8u_exact_loa4"]
