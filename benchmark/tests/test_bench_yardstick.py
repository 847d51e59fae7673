"""The frozen yardstick: peaks, work models, profiler arithmetic."""

import pytest

from benchmark.run import load_spec, cell_parts
from benchmark.yardstick import kernels, peaks, trace, work_rs, work_tpke
from benchmark.yardstick.trace import Event


def test_b1_bound_at_rs64_inst1024():
    spec = load_spec()
    _, config, traffic = cell_parts(spec, "rs64-inst1024")
    cols = work_rs.shapes(config, traffic)["cols"]
    assert cols == 1024 * 64 * 12
    enc_ops, enc_bytes = peaks.gf_matmul_ms(42, 22, cols)
    rec_ops, rec_bytes = peaks.gf_matmul_ms(22, 22, cols)
    assert round(enc_ops, 4) == 0.0470 and round(rec_ops, 4) == 0.0246
    assert enc_bytes < enc_ops and rec_bytes < rec_ops  # bound by operations
    assert work_rs.epoch(config, traffic)["bound_ms"] == pytest.approx(enc_ops + rec_ops)


def test_rs64_batch64k_shapes():
    _, config, traffic = cell_parts(load_spec(), "rs64-batch64k")
    s = work_rs.shapes(config, traffic)
    assert s["shard_len"] == 11637 and s["cols"] == 64 * 11637
    assert round(work_rs.epoch(config, traffic)["bound_ms"], 4) == 0.0678


def test_peaks_are_the_data_sheets():
    assert peaks.PEAK_INT8_OPS_PER_S == 1979e12 and peaks.PEAK_BYTES_PER_S == 3.35e12
    assert peaks.OPS_PER_PRODUCT == 2 * (48 * 48 + 48 * 49 // 2 + 48 * 48) == 11568


def test_tpke_work_model():
    # per ciphertext at q = 22: table 1,063, 23 ladders of 1,600, the combine 29,050, 24 more
    assert work_tpke.products_per_ciphertext(22) == 1063 + 23 * 1600 + 29050 + 24 == 66937
    spec = load_spec()
    _, config, traffic = cell_parts(spec, "tpke64-inst64")
    w = work_tpke.epoch(config, traffic)
    assert w["ops"] == 4096 * 66937 * 11568
    assert round(w["bound_ms"], 4) == 1.6026
    _, config1, traffic1 = cell_parts(spec, "tpke64-inst1")
    assert work_tpke.epoch(config1, traffic1)["bound_ms"] == pytest.approx(w["bound_ms"] / 64)


def test_union_and_gaps():
    dev = [Event("k1", 0, 10), Event("k2", 5, 20), Event("copy", 30, 35), Event("k1", 50, 60)]
    assert trace.merged((e.start, e.end) for e in dev) == [(0, 20), (30, 35), (50, 60)]
    assert trace.busy_us(dev) == 35
    assert trace.by_name(dev) == {"k1": 20, "k2": 15, "copy": 5}
    host = [Event("aten::roll", 18, 29), Event("cudaStreamSynchronize", 36, 52)]
    assert trace.idle_gaps(dev, host) == {"cudaStreamSynchronize": 15, "aten::roll": 10}
    assert trace.idle_gaps(dev, []) == {"host: outside any op": 25}


def test_every_hand_written_kernel_is_in_the_frozen_table():
    assert kernels.unlisted() == []
    assert set(kernels.hand_written()) == set(kernels.listed())
    assert kernels.listed("B2", "B3") == ["circuit_chain_kernel", "circuit_kernel",
                                         "fq_point_block_kernel", "fq_point_kernel"]


@pytest.mark.parametrize("source, name", [
    ("moved.cu", "template <int K>\n__global__ void __launch_bounds__(256) gf_fused_kernel(int* x) {}"),
    ("fast.py", "import triton\n\n@triton.jit\ndef gf_triton_kernel(x_ptr):\n    pass\n"),
])
def test_a_moved_kernel_stays_in_the_roofline(tmp_path, source, name):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "gf256_matmul.cu").write_text("__global__ void gf256_mma_kernel(int* x) {}")
    (tmp_path / "csrc" / source).write_text(name)
    new = "gf_fused_kernel" if source.endswith(".cu") else "gf_triton_kernel"
    assert kernels.unlisted(tmp_path) == [new]
    events = [Event("void gf256_mma_kernel<64>(unsigned char const*)", 0, 30),
              Event(f"void {new}<4>(int*)", 40, 50), Event("void at::native::roll_kernel", 60, 65)]
    assert kernels.device_us(events, kernels.listed("B1")) == 30
    assert kernels.device_us(events, kernels.unlisted(tmp_path)) == 10
    assert not kernels.matches("circuit_chain_kernel", ["chain_kernel"])


def test_readers_charge_an_unlisted_kernel_to_the_roofline(monkeypatch):
    from types import SimpleNamespace

    from benchmark.run import load_module

    spec = load_spec()
    _, config, traffic = cell_parts(spec, "rs64-inst1024")
    bound_ms = work_rs.epoch(config, traffic)["bound_ms"]
    monkeypatch.setattr(kernels, "unlisted", lambda: ["gf_fused_kernel"])
    events = [Event("void gf256_mma_kernel<64>(unsigned char const*)", 0, 100),
              Event("void gf_fused_kernel(int*)", 100, 300), Event("Memcpy DtoH", 300, 340)]
    ctx = SimpleNamespace(config=config, traffic=traffic, device_events=events, epochs=2)
    read = {m: load_module("metrics", m).read(ctx) for m in
            ("rs_roofline", "glue_ms_per_epoch", "unlisted_kernel_ms_per_epoch")}
    assert read["rs_roofline"] == pytest.approx(100 * bound_ms / 0.15)
    assert read["glue_ms_per_epoch"] == pytest.approx(0.02)
    assert read["unlisted_kernel_ms_per_epoch"] == pytest.approx(0.1)
    ctx.device_events = events[1:]  # B1 renamed: the new kernel still reads
    assert load_module("metrics", "rs_roofline").read(ctx) == pytest.approx(100 * bound_ms / 0.1)
