"""SAM2 training: the port's family and Trainer against the JAX package's, f32, CPU.

On ``SAM2Config.tiny_test()`` (LoRA rank 128, α 128, as the family builds
it; two cond slots) with the port's seeded weights moved by N(0, 0.05²),
taken into JAX's tree by ``convert_sam2_state_dict``:

- one train step (``Trainer.train_step`` against the JAX ``Trainer``'s
  jitted step, the order [0, 2, 1] with two cond slices): probabilities
  within atol 2e-3, the total loss (Dice + ``mask_loss``) and ``mask_loss``
  within 2e-3, the gradient of every trained leaf (LoRA factors, prompt
  predictor, SAM2-level embeddings) within atol 5e-4, probabilities after
  the two-group AdamW update within atol 5e-3, and every frozen parameter
  unchanged bit for bit (the bounds of ``tests/test_sam2_train_parity.py``);
- the ``.model`` artifact both ways: the JAX package's ``save_torch_model``
  read strictly by the port with ``export_sam2_state_dict``'s keys and
  values, and the port's ``save_model`` read back by the JAX package's
  reader with the same;
- ``cryovit-torch train --model sam2`` on two tiny tomograms, then
  ``evaluate`` and ``infer`` on its artifact;
- ``sam2_from_published`` on a published-format dict: the JAX converter's
  tensors, under the port's names; ``run_training`` laying such a
  checkpoint found under ``model_dir/SAM2`` over its initial weights;
- ``prepare_inputs``: the cond-slice draw from the family's own generator
  and cached ``sam_features`` in the forward's layout;
- MedSAM's Hiera-T refused by both packages (ROADMAP C2).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cryovit_tpu.models.losses import DiceLoss as JaxDiceLoss
from cryovit_tpu.models.metrics import DiceMetric as JaxDiceMetric
from cryovit_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from cryovit_tpu.models.sam2.convert import convert_sam2_state_dict
from cryovit_tpu.models.sam2.encoder import ImageEncoder as JaxImageEncoder
from cryovit_tpu.models.sam2.family import SAM2 as JaxSAM2
from cryovit_tpu.train.loop import Trainer as JaxTrainer
from cryovit_tpu.train.loop import TrainState
from cryovit_tpu.train.torch_export import save_torch_model
from cryovit_tpu.train.torch_export_sam2 import export_sam2_state_dict
from cryovit_tpu.train.torch_import import load_reference_model
from cryovit_tpu_torch.cli.main import main
from cryovit_tpu_torch.convert import sam2_from_jax, sam2_from_published
from cryovit_tpu_torch.models import SAM2
from cryovit_tpu_torch.models.losses import DiceLoss
from cryovit_tpu_torch.models.metrics import DiceMetric
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.family import param_group
from cryovit_tpu_torch.models.sam2.model import random_sam2_state_dict
from cryovit_tpu_torch.train.checkpoint import load_model, save_model
from cryovit_tpu_torch.train.loop import Trainer

KW = {"test_config": True, "prompt_lr": 2e-3, "num_init_cond_slices": (2, 1)}
ORDER, NUM_COND = [0, 2, 1], 2


def families():
    jax_fam = JaxSAM2(name="SAM2", input_key="data", lr=1e-3, weight_decay=1e-3,
                      losses={"dice_loss": JaxDiceLoss()},
                      metrics={"dice_metric": JaxDiceMetric(0.5)}, custom_kwargs=dict(KW))
    fam = SAM2(name="SAM2", input_key="data", lr=1e-3, weight_decay=1e-3,
               losses={"dice_loss": DiceLoss()}, metrics={"dice_metric": DiceMetric(0.5)},
               custom_kwargs=dict(KW))
    return jax_fam, fam


@pytest.fixture(scope="module")
def weights():
    """(the port's state dict, the JAX family's variables)."""
    cfg = dataclasses.replace(SAM2Config.tiny_test(), max_cond_slices=2)
    rng = np.random.default_rng(21)
    sd = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in random_sam2_state_dict(cfg, torch.Generator().manual_seed(20)).items()}
    sd["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"][:] = 3.0
    jcfg = dataclasses.replace(JaxSAM2Config.tiny_test(), max_cond_slices=2)
    variables = jax.tree_util.tree_map(jnp.asarray, convert_sam2_state_dict(sd, jcfg))
    return sd, variables


def test_train_step_matches_the_jax_trainer(weights):
    sd, variables = weights
    jax_fam, fam = families()
    rng = np.random.default_rng(22)
    x = rng.random((1, 3, 64, 64, 1)).astype(np.float32)
    label = (rng.random((1, 3, 64, 64)) > 0.5).astype(np.int8)
    label[:, :, :8] = -1

    opt = jax_fam.make_optimizer()
    step = JaxTrainer(precision="f32")._train_step_fn(jax_fam, opt)
    inputs = {"slices": jnp.asarray(x), "order": jnp.asarray(ORDER), "num_cond": jnp.asarray(NUM_COND)}
    y = jnp.asarray(label, jnp.float32)

    @jax.jit
    def run(state):
        def loss_fn(params):
            preds, aux = jax_fam.apply_with_aux(params, inputs)
            from cryovit_tpu.models.base import prediction_mask

            return jax_fam.compute_losses(preds, y, prediction_mask(y), aux=aux)["total"]

        grads = jax.grad(loss_fn)(state.params)
        new_state, logs = step(state, inputs, y)
        return (jax_fam.apply(state.params, inputs), grads, logs,
                jax_fam.apply(new_state.params, inputs))

    preds0, grads, logs, preds1 = run(TrainState.create(variables, opt))

    module = fam.build_module(sam2_from_jax(variables), torch.device("cpu"))
    frozen = {n: p.detach().clone() for n, p in module.named_parameters() if not p.requires_grad}
    trainer = Trainer(precision="f32", device="cpu")
    trainer.model, trainer.module, trainer.optimizer = fam, module, fam.make_optimizer(module)
    tin = {"slices": torch.from_numpy(x), "order": ORDER, "num_cond": NUM_COND}
    with torch.no_grad():
        p0 = fam.apply(module.eval(), tin)
    tlogs = trainer.train_step(tin, torch.from_numpy(label))
    with torch.no_grad():
        p1 = fam.apply(module.eval(), tin)

    np.testing.assert_allclose(p0.numpy(), np.asarray(preds0), atol=2e-3)
    for key in ("train_total", "train_mask_loss", "train_dice_loss"):
        assert abs(float(tlogs[key]) - float(logs[key])) < 2e-3, (key, tlogs[key], logs[key])
    want = sam2_from_jax(grads)
    trained = [n for n, p in module.named_parameters() if p.requires_grad]
    assert any(".w_a." in n for n in trained) and any(n.startswith("prompt_predictor.") for n in trained)
    for name in trained:
        np.testing.assert_allclose(module.get_parameter(name).grad.numpy(), want[name], atol=5e-4,
                                   err_msg=name)
    np.testing.assert_allclose(p1.numpy(), np.asarray(preds1), atol=5e-3)
    assert not np.allclose(p1.numpy(), p0.numpy(), atol=1e-6), "the update moved nothing"
    for name, before in frozen.items():
        assert torch.equal(module.get_parameter(name), before), name
        assert param_group(name) == "frozen"


def test_model_artifact_both_ways(weights, tmp_path):
    """The JAX package's SAM2 ``.model`` loads strictly into the port with
    export_sam2_state_dict's keys and values; the port's own ``.model`` is
    read back by the JAX package's reader with the same."""
    sd, variables = weights
    jax_fam, _ = families()
    path = save_torch_model("sam_mito", "mito", jax_fam, variables, tmp_path / "jax.model")
    want = export_sam2_state_dict(variables, jax_fam.sam_cfg)
    module, model_type, name, label_key = load_model(path, device="cpu")
    got = module.state_dict()
    assert (model_type.value, name, label_key) == ("sam2", "sam_mito", "mito")
    assert set(got) == set(want) == set(sd)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    back = save_model("sam_mito", "mito", module, tmp_path / "port.model")
    ref_name, ref_type, ref_label, ref_sd = load_reference_model(back)
    assert (ref_name, ref_type.value, ref_label) == ("sam_mito", "sam2", "mito")
    assert set(ref_sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(ref_sd[k]), want[k], err_msg=k)


def _tomograms(root, n=2):
    """``n`` 5x40x40 uint8 tomograms and their labels (the first slice
    unlabeled) as HDF5 files under ``root/{tomos,labels}``."""
    from cryovit_tpu_torch.io import write_hdf

    rng = np.random.default_rng(23)
    for sub in ("tomos", "labels"):
        (root / sub).mkdir()
    for i in range(n):
        write_hdf(root / f"tomos/t{i}.hdf",
                  {"data": rng.integers(0, 255, (5, 40, 40)).astype(np.uint8)})
        lab = (rng.random((5, 40, 40)) > 0.5).astype(np.int8)
        lab[0] = -1
        write_hdf(root / f"labels/t{i}.hdf", {"mito": lab})
    return str(root / "tomos"), str(root / "labels")


def test_cli_train_sam2_then_evaluate_and_infer(tmp_path, monkeypatch):
    """``train --model sam2`` with ``SAM2Config.large`` standing for
    ``tiny_test``, then ``evaluate`` and ``infer`` on its artifact."""
    from cryovit_tpu_torch.io import read_hdf

    monkeypatch.setattr(SAM2Config, "large", classmethod(lambda cls: cls.tiny_test()))
    tomos, labels = _tomograms(tmp_path)
    assert main(["train", tomos, labels, "mito", "--labels", "mito", "--model", "sam2",
                 "--num-epochs", "1", "--device", "cpu",
                 "--result-folder", str(tmp_path / "run")]) == 0
    artifact = tmp_path / "run/sam2_mito.model"
    module, model_type, *_ = load_model(artifact, device="cpu")
    assert model_type.value == "sam2" and module.cfg == SAM2Config.tiny_test()
    assert main(["evaluate", tomos, labels, str(artifact), "--labels", "mito", "--device", "cpu",
                 "--result-folder", str(tmp_path / "ev")]) == 0
    rows = (tmp_path / "ev/results/sam2_mito/tomos.csv").read_text().splitlines()
    assert rows[0] == "sample,tomo_name,dice_metric,f1_metric" and len(rows) == 3
    assert main(["infer", tomos, "--model", str(artifact), "--device", "cpu",
                 "--result-folder", str(tmp_path / "inf")]) == 0
    masks = sorted((tmp_path / "inf").rglob("*.hdf"))
    assert len(masks) == 2
    _, mask, _ = read_hdf(masks[0], key="mito")
    assert mask.shape == (5, 40, 40)


def test_published_checkpoint_is_laid_over_the_initial_weights(tmp_path):
    """``run_training`` finds ``model_dir/SAM2/sam2.1_hiera_large.pt`` (the
    published format) and trains from it: the frozen modules of the
    ``.model`` hold the checkpoint's tensors exactly, the LoRA factors and
    the prompt predictor their own (trained) values."""
    from test_sam2_torch_parity import _published_full_state_dict

    from cryovit_tpu_torch.config import MODELS, TrainConfig
    from cryovit_tpu_torch.run.train_model import run_training

    published = _published_full_state_dict(JaxSAM2Config.tiny_test(), np.random.default_rng(25))
    (tmp_path / "models/SAM2").mkdir(parents=True)
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in published.items()}},
               tmp_path / "models/SAM2/sam2.1_hiera_large.pt")
    tomos, labels = _tomograms(tmp_path, n=1)
    model = dataclasses.replace(MODELS["sam2"],
                                custom_kwargs=MODELS["sam2"].custom_kwargs + (("test_config", True),))
    cfg = TrainConfig(label_key="mito", model=model, model_dir=str(tmp_path / "models"))
    files = sorted((tmp_path / "tomos").iterdir()), sorted((tmp_path / "labels").iterdir())
    path = run_training(*files, ["mito"], "mito", "sam2_mito", tmp_path / "run", num_epochs=1,
                        device="cpu", config=cfg)
    module, *_ = load_model(path, device="cpu")
    got = module.state_dict()
    pub = sam2_from_published(published)
    for k, v in pub.items():
        if param_group(k) == "frozen":
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert any(param_group(k) != "frozen" for k in pub)  # the SAM2-level embeddings train


def test_sam2_from_published_matches_the_jax_converter():
    from test_sam2_torch_parity import _published_full_state_dict

    cfg = JaxSAM2Config.tiny_test()
    published = _published_full_state_dict(cfg, np.random.default_rng(24))
    # the JAX converter's tree has rank-0 (published) decoder projections;
    # the port keeps a LoRA-wrapped projection's base under .proj
    lora_base = re.compile(r"(transformer\..*(?:attn|token|image)\.[qv]_proj)\.(weight|bias)$")
    want = {lora_base.sub(r"\1.proj.\2", k): v
            for k, v in sam2_from_jax(convert_sam2_state_dict(published, cfg)).items()}
    got = sam2_from_published(published)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # what a published checkpoint lacks is exactly the LoRA factors and the
    # prompt predictor
    own = random_sam2_state_dict(SAM2Config.tiny_test(), torch.Generator().manual_seed(0), 4, 4.0)
    assert set(got) <= set(own)
    assert all(k.endswith((".w_a.weight", ".w_b.weight")) or k.startswith("prompt_predictor.")
               for k in set(own) - set(got))
    assert all(tuple(own[k].shape) == got[k].shape for k in got)


def test_prepare_inputs_draws_cond_slices_and_passes_cached_pyramids():
    """As the JAX family's (``tests/test_sam2.py::test_family_cond_slice_sampling``):
    in train mode a random cond count in [1, 3] with slice 0 first and the
    order a permutation, the eval count 1 taking the default path; with
    ``use_cache_features`` one item's ``sam_features`` (file layout
    ``(D, C, h, w)``) become flat channels-last levels zero-padded to the
    input's depth. The draws come from the family's own generator: the same
    ``cond_seed`` gives the same draws."""
    from cryovit_tpu_torch.types import TomogramData

    def family(seed):
        return SAM2(name="SAM2", input_key="data", lr=5e-5, losses={}, metrics={},
                    custom_kwargs={"test_config": True, "num_init_cond_slices": (3, 1),
                                   "rand_init_cond_slices": (True, False),
                                   "use_cache_features": True, "cond_seed": seed})

    data = torch.rand(1, 6, 64, 64, 1)
    levels = [np.random.default_rng(i).standard_normal((5, 32, s, s)).astype(np.float32)
              for i, s in enumerate((16, 8, 4))]
    item = TomogramData(sample="s", tomo_name="t.hdf", split_id=None, data=data[0].numpy(),
                        label=np.zeros((6, 64, 64), np.int8),
                        aux_data={"sam_features": {"backbone_fpn": levels, "vision_pos_enc": levels}})
    fam, twin = family(7), family(7)
    assert fam.sam_cfg.max_cond_slices == 3
    fam.train_mode = twin.train_mode = True
    seen = set()
    for _ in range(12):
        inputs, again = fam.prepare_inputs(data, [item]), twin.prepare_inputs(data, [item])
        assert (inputs["order"], inputs["num_cond"]) == (again["order"], again["num_cond"])
        assert inputs["order"][0] == 0 and sorted(inputs["order"]) == list(range(6))
        assert 1 <= inputs["num_cond"] <= 3
        seen.add(inputs["num_cond"])
    assert len(seen) > 1
    backbone = inputs["backbone"]["backbone_fpn"]
    assert [tuple(b.shape) for b in backbone] == [(6, 16, 16, 32), (6, 8, 8, 32), (6, 4, 4, 32)]
    np.testing.assert_array_equal(backbone[1][:5].numpy(), np.moveaxis(levels[1], 1, -1))
    assert not backbone[1][5:].any()
    fam.train_mode = False
    inputs = fam.prepare_inputs(data, [item])
    assert "order" not in inputs and inputs["slices"] is data


@pytest.mark.parametrize("package", ["port", "jax"])
def test_medsam_tiny_is_refused_by_both_packages(package, tmp_path):
    """Hiera-T's q-pool block 10 pools 7x7 windows: the port refuses it up
    front, naming C2; the JAX package fails at the reshape."""
    if package == "port":
        with pytest.raises(ValueError, match="C2"):
            SAM2(name="MedSAM", input_key="data", lr=5e-5, losses={}, metrics={})
        with pytest.raises(ValueError, match="C2"):
            main(["train", str(tmp_path), str(tmp_path), "mito", "--labels", "mito",
                  "--model", "medsam", "--device", "cpu"])
    else:
        enc = JaxImageEncoder(JaxSAM2Config.medsam_tiny())
        with pytest.raises(TypeError, match="reshape"):
            jax.eval_shape(enc.init, jax.random.key(0), jnp.zeros((1, 512, 512, 3)))


def test_kept_casts_give_the_bits_of_casting_at_each_use(monkeypatch):
    """bf16 on the CPU, 5 slices: two train steps with an AdamW update
    between them, an ``inference_mode`` pass, and a step after a frozen
    weight changed in place. The heads' kept bf16 copies of their frozen
    weights give exactly the probabilities and gradients of casting every
    weight at every use; one copy is kept per frozen weight that is cast
    (the count does not grow with the slices or the steps), and a changed
    weight is cast anew."""
    import contextlib

    from cryovit_tpu_torch.models.base import prediction_mask
    from cryovit_tpu_torch.models.sam2 import model as sam2_model

    fam = SAM2(name="SAM2", input_key="data", lr=1e-3, losses={"dice_loss": DiceLoss()},
               metrics={}, dtype=torch.bfloat16, custom_kwargs=dict(KW))
    sd = random_sam2_state_dict(fam.sam_cfg, torch.Generator().manual_seed(41))
    gen = torch.Generator().manual_seed(42)
    for k in sd:  # LoRA's B off zero and the object gate open, so every weight counts
        if k.endswith(".w_b.weight"):
            sd[k] = 0.02 * torch.randn(sd[k].shape, generator=gen)
    sd["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(3.0)
    x = torch.rand(1, 5, 64, 64, 1, generator=gen)
    label = (torch.rand(1, 5, 64, 64, generator=gen) > 0.5).to(torch.int8)
    inputs = {"slices": x, "order": [0, 3, 1, 2, 4], "num_cond": 2}
    frozen = "model.sam_mask_decoder.transformer.layers.0.mlp.layers.0.weight"

    def run(keep: bool):
        if not keep:
            monkeypatch.setattr(sam2_model, "casts_kept_in", lambda kept: contextlib.nullcontext())
        module = fam.build_module(sd, "cpu")
        opt = fam.make_optimizer(module)
        out = []
        for step in range(3):
            if step == 2:
                with torch.no_grad():
                    dict(module.named_parameters())[frozen].mul_(1.5)
            opt.zero_grad()
            preds, aux = fam.apply_with_aux(module, inputs)
            fam.compute_losses(preds, label, prediction_mask(label), aux=aux)["total"].backward()
            out.append((preds.detach(), {n: p.grad.clone() for n, p in module.named_parameters()
                                         if p.grad is not None}))
            opt.step()
            if step == 0:
                with torch.inference_mode():
                    out.append((fam.apply(module, inputs), {}))
                kept_after_one_step = len(module._head_casts)
        monkeypatch.undo()
        return out, (kept_after_one_step, len(module._head_casts)), module

    kept, (n_first, n_last), module = run(True)
    plain, (n_plain, _), _ = run(False)
    frozen_cast = [n for n, p in module.named_parameters()
                   if not p.requires_grad and not n.startswith("model.image_encoder.")]
    assert n_plain == 0 and 0 < n_first == n_last <= len(frozen_cast)
    assert not torch.equal(kept[2][0], kept[3][0])  # the changed weight counts
    for (pk, gk), (pp, gp) in zip(kept, plain, strict=True):
        assert torch.equal(pk, pp)
        assert gk.keys() == gp.keys() and all(torch.equal(gk[n], gp[n]) for n in gk)
