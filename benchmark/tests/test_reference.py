"""Each plain reference agrees with the port at tiny sizes on the CPU, in
float32, from the same drawn weights: a ViT of width 64 (the port's
``make_dinov2``), the CryoVIT decoder at its own widths (``make_cryovit``),
forward and, for the trained decoder, the gradients."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from conftest import tiny_cell

from harness import traffic as T
from harness import weights as W
from reference import infer as ref_infer
from reference import train as ref_train
from reference.cryovit import CryoVIT as RefDecoder
from reference.dinov2 import DinoV2 as RefBackbone

CPU = torch.device("cpu")


def _load(ref_cls, cfg, rules, seed, *args):
    with torch.device("meta"):
        model = ref_cls(cfg, *args)
    sd = W.draw(W.shapes_of(model), rules, T.generator(seed, 1, CPU), torch.float32)
    model.load_state_dict(sd, assign=True)
    return model, sd


def test_dinov2_matches_port():
    from cryovit_tpu_torch.data.transforms import dino_device_preprocess
    from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2

    cfg = tiny_cell("cryovit_vitg14.infer")["config_spec"]
    ref, sd = _load(RefBackbone, cfg, cfg["init"]["backbone"], 3)
    port = make_dinov2(sd, DinoV2Config(patch_size=14, embed_dim=64, depth=2, num_heads=4,
                                        ffn_hidden=56, num_registers=4, pos_grid=5), CPU,
                       torch.float32)
    x = torch.rand(3, 64, 64)
    with torch.no_grad():
        want = ref(F.interpolate(x[:, None], size=(56, 56), mode="bicubic",
                                 align_corners=False)[:, 0])
        got = port(dino_device_preprocess(x))
    assert got.shape == want.shape == (3, 16, 64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_trained_decoder_matches_port():
    from cryovit_tpu_torch.models.cryovit import make_cryovit

    cfg = tiny_cell("cryovit_vitg14.train")["config_spec"]
    ref, sd = _load(RefDecoder, cfg, cfg["init"]["decoder"], 4)
    port = make_cryovit(sd, CPU, torch.float32, trainable=True)
    x = torch.randn(1, 8, 2, 2, 64)
    label = (torch.rand(1, 8, 32, 32) > 0.5).to(torch.int8)
    label[:, :1] = -1
    got = port(x)
    want = ref(x.permute(0, 4, 1, 2, 3))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    from cryovit_tpu_torch.models.losses import dice_loss

    loss_port = dice_loss(got, label, label > -1)
    loss_ref = ref_train.dice_loss(want, label)
    torch.testing.assert_close(loss_port, loss_ref, rtol=1e-5, atol=1e-6)
    loss_port.backward()
    loss_ref.backward()
    ref_grads = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        torch.testing.assert_close(p.grad, ref_grads[name].grad, rtol=2e-3, atol=1e-6,
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_mrc_round_trip(tmp_path):
    from cryovit_tpu_torch.io import load_data

    vol, _ = T.blob_volume(T.generator(5, 1, CPU), 8, 32, tiny_cell("cryovit_vitg14.infer")[
        "traffic_spec"])
    path = tmp_path / "t.mrc"
    T.write_mrc_int8(path, vol)
    port, _ = load_data(path, key="data")
    ref = ref_infer.normalized(ref_infer.read_mrc(path))
    assert np.array_equal(port[0], ref)
    assert np.array_equal(ref, (vol.numpy().astype(np.int16) - 128).astype(np.float32) / 255)
