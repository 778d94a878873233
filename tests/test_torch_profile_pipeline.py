"""`scripts/profile_pipeline_torch.py`'s analytic UNet FLOP count (the
numerator of its MFU, where the JAX script asked XLA's cost analysis)
against `torch.utils.flop_counter.FlopCounterMode` over the UNet's plain
CPU path, within 1%: an SD1.5-layout UNet (four levels, attention off at
the lowest down and highest up level) and an SDXL-layout one (transformer
depths and heads per level, a deeper mid block, the addition embedding),
at tiny widths, odd batch and context lengths. The counter sees the
convolutions, the linear layers' matrix products and the attentions' two
batched products (the plain flash version's).
"""

from __future__ import annotations

import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from adaface_tpu_torch.models.unet import SD15_UNET, UNet2DConditionModel, UNetConfig
from tests.test_torch_eval_cli import REPO
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(REPO / "scripts"))
import profile_pipeline_torch as prof  # noqa: E402

CONFIGS = {
    "sd15_layout": UNetConfig(block_channels=(16, 32, 32, 32), cross_attn_dim=64, num_heads=2,
                              norm_groups=8, time_embed_dim=64),
    "sdxl_layout": UNetConfig(block_channels=(16, 32, 64), down_has_attn=(False, True, True),
                              up_has_attn=(True, True, False), transformer_depth=(1, 2, 3),
                              mid_transformer_depth=3, block_num_heads=(2, 2, 4),
                              cross_attn_dim=48, addition_time_embed_dim=8,
                              addition_pooled_dim=24, norm_groups=8, time_embed_dim=64),
}


@pytest.mark.parametrize("name,batch,hw,ctx_len", [("sd15_layout", 3, 16, 11),
                                                   ("sd15_layout", 2, 8, 77),
                                                   ("sdxl_layout", 3, 16, 11)])
def test_unet_flops_match_flop_counter(name, batch, hw, ctx_len):
    cfg = CONFIGS[name]
    torch.manual_seed(0)
    model = UNet2DConditionModel(cfg).eval()
    x = torch.randn(batch, 4, hw, hw)
    t = torch.arange(batch) * 100
    ctx = torch.randn(batch, ctx_len, cfg.cross_attn_dim)
    kw = {}
    if cfg.addition_time_embed_dim is not None:
        kw["added_cond"] = {"text_embeds": torch.randn(batch, cfg.addition_pooled_dim),
                            "time_ids": torch.randn(batch, 6)}
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, t, ctx, **kw)
    counted = counter.get_total_flops()
    got = prof.unet_flops(cfg, batch, hw, ctx_len)
    assert counted > 0 and abs(got / counted - 1) <= 0.01, (got, counted)


def test_sd15_cfg_call_count_and_peak():
    """The figure the CLI divides: an SD1.5 call at CFG batch 2 (one image),
    linear in the batch; the peak is the H100's dense bf16 rate, no TPU's."""
    one = prof.unet_flops(SD15_UNET, 2)
    assert prof.unet_flops(SD15_UNET, 16) == 8 * one
    assert 1.5e12 < one < 1.7e12  # ≈ 0.8 TFLOPs an image
    assert prof.BF16_PEAK == 989e12
    assert "197" not in (REPO / "scripts" / "profile_pipeline_torch.py").read_text()


class KinetoEvent:
    """The fields of a kineto result event that `device_events` reads."""

    def __init__(self, name, start_us, end_us, device="cuda", hidden=False, async_=False,
                 threads=(1, 1)):
        self._name, self._ns = name, (int(start_us * 1e3), int(end_us * 1e3))
        self._device, self._hidden, self._async, self._threads = device, hidden, async_, threads

    def name(self):
        return self._name

    def device_type(self):
        return getattr(torch.autograd.DeviceType, self._device.upper())

    def is_hidden_event(self):
        return self._hidden

    def is_async(self):
        return self._async

    def start_thread_id(self):
        return self._threads[0]

    def end_thread_id(self):
        return self._threads[1]

    def start_ns(self):
        return self._ns[0]

    def end_ns(self):
        return self._ns[1]


def test_device_events_reads_what_profiler_events_keep():
    """The one reader of device time (`utils/profiling.py`): device events
    only, the utility names and hidden events left out, an asynchronous
    event (or one that ends on another thread) counted at 0 µs."""
    from types import SimpleNamespace

    from adaface_tpu_torch.utils.profiling import DeviceEvent, device_events

    events = [KinetoEvent("gn_fused_kernel", 10.0, 12.5),
              KinetoEvent("aten::add", 10.0, 30.0, device="cpu"),
              KinetoEvent("flash_fwd_wg_kernel", 13.0, 20.0, hidden=True),
              KinetoEvent("Memcpy DtoD (Device -> Device)", 21.0, 22.0, async_=True),
              KinetoEvent("Memset (Device)", 23.0, 23.5, threads=(1, 2)),
              KinetoEvent("aten::is_leaf", 24.0, 25.0),
              KinetoEvent("ProfilerStep#3", 0.0, 40.0)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert device_events(prof) == [DeviceEvent("gn_fused_kernel", 10.0, 2.5),
                                   DeviceEvent("Memcpy DtoD (Device -> Device)", 21.0, 0.0),
                                   DeviceEvent("Memset (Device)", 23.0, 0.0),
                                   DeviceEvent("ProfilerStep*", 0.0, 40.0)]
