"""The port's train forward of xlstm-350m, of moe-gqa (deepseek-v3's
smoke with GQA attention: ``attn_moe`` blocks, capacity drops, the aux
loss) and of ``attn_local`` blocks against the JAX reference's on the
CPU, at smoke size, and the train CLI on the families past the dense
decoders.

``lm.forward``'s loss within ``LOSS_RTOL``, logits bit-equal to
``jax.jit(jax.value_and_grad(lm.forward))`` and every gradient leaf held
(``_torch_train.hold_grads``), remat on and off bit-identical in the
port.  The window case is codeqwen1.5-7b's smoke with every block
``attn_local`` at window 8 (keys outside it at S 16)."""

import math

import pytest
import torch

from repro_torch.launch import train as cli

from _torch_train import forward_parity


@pytest.mark.parametrize("arch,over", [
    ("xlstm-350m", ()),
    ("deepseek-v3-671b", (("attn_kind", "gqa"),)),
    ("codeqwen1.5-7b", (("family", "hybrid"),
                        ("block_pattern", ("attn_local",)),
                        ("local_window", 8))),
], ids=["xlstm-350m", "moe-gqa", "codeqwen-attn_local"])
def test_forward_loss_logits_and_grads_match_jax(arch, over):
    assert forward_parity(arch, over) > 0


def test_train_cli_xlstm_on_cpu():
    """``python -m repro_torch.launch.train --arch xlstm-350m --smoke
    --device cpu``, shortened: finite losses and gradient norms, the
    train linears' f32 masters."""
    loop, params = cli.main(["--arch", "xlstm-350m", "--smoke", "--device",
                             "cpu", "--steps", "2", "--seq-len", "16",
                             "--batch", "2"])
    assert [m["step"] for m in loop.metrics_log] == [0, 1]
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["gnorm"])
               for m in loop.metrics_log)
    cell = params.tree()["segments"][0]["b7"]["cell"]    # the sLSTM
    assert cell["wx"]["w"].dtype == torch.float32 and "aq" in cell["wx"]


def test_train_cli_seamless_preempted_on_cpu(tmp_path, capsys):
    """The CLI on seamless-m4t-medium's smoke (frames of ``seq_len //
    2``), checkpointed every step and preempted once: the restart restores
    every leaf (encoder, ``front``, cross-attention) and the run ends with
    finite losses."""
    loop, params = cli.main([
        "--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu",
        "--steps", "3", "--seq-len", "16", "--batch", "2", "--ckpt-dir",
        str(tmp_path), "--ckpt-interval", "1", "--preempt-at", "1"])
    assert "finished with 1 restarts" in capsys.readouterr().out
    assert sorted({m["step"] for m in loop.metrics_log}) == [0, 1, 2]
    assert all(math.isfinite(m["loss"]) for m in loop.metrics_log)
    tree = params.tree()
    assert {"front", "encoder", "enc_norm"} <= set(tree)
    assert "xattn" in tree["segments"][0]["b0"]
