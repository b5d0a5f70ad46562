"""The sharded dense serve path (``lm.prefill``/``lm.decode_step`` under a
``(data, model)`` mesh, on this rank's blocks) on 4 gloo ranks against the
reference's 4-device run of the same jitted forwards, on the same params
and tokens (``tests/_torch_sharded.py``): the tlmac layout of the dense
GQA decoders, bit for bit.

Cases (B 4 x 16 tokens into S_max 32, then 10 greedy steps):

- codeqwen1.5-7b smoke, mesh (1, 4): MHA with QKV bias, the batch
  replicated (data 1), sequence-sharded caches;
- mistral-large-123b smoke with ``fsdp``, mesh (2, 2): GQA with 2 KV
  heads, ``exec_idx`` on 'model' and its reduction groups on ('pod',
  'data') (gathered at use), the batch over 'data';
- minicpm-2b smoke, mesh (1, 4): replicated plans (wq/wk/wv/wo, the
  FFN's ``wo``) beside 'model'-sharded ``w_step``, tied embeddings, vocab
  257 padded to 272;
- codeqwen smoke widened to 16 heads of 16 (d_model 256), mesh (2, 2):
  16 KV heads, so head-sharded caches.

Each rank's tokens, prefill and last logits (its rows, its vocab block)
and cache blocks equal the reference's bit for bit, and the port's own
unsharded run's; its param blocks are the reference's per-device blocks;
its collectives a decode step are the ones stated in ``PER_STEP``.
"""

import numpy as np
import pytest

import _torch_sharded as H

CASES = {
    "codeqwen-1x4": dict(arch="codeqwen1.5-7b", over={}, mesh=(1, 4)),
    "mistral-fsdp-2x2": dict(arch="mistral-large-123b", over={"fsdp": True},
                             mesh=(2, 2), hlo=True),
    "minicpm-1x4": dict(arch="minicpm-2b", over={}, mesh=(1, 4)),
    "codeqwen-16kv-2x2": dict(arch="codeqwen1.5-7b", over=dict(
        n_heads=16, n_kv=16, head_dim=16, d_model=256), mesh=(2, 2)),
}
# collectives a decode step on each rank (2 layers):
# (all-gathers, all-reduces, of them parameter gathers, their bytes).
# A layer with sequence-sharded caches gathers q, k and v over 'model'
# (every head attends over the rank's positions) and reduces the softmax's
# max, denominator and weighted V; one whose plan shards the output tiles
# gathers the FFN's gated codes into wo and the two output-split linears'
# outputs (wo, FFN wo); a replicated wo instead gathers its input codes.
# Each step adds the embedding's sum and the greedy argmax's max and min.
PER_STEP = {
    # per layer: AG q, k, v, attn-wo out, ffn-wo in, ffn-wo out; AR 3
    "codeqwen-1x4": (12, 9, 0, 0),
    # the same, plus 14 FSDP gathers a layer (exec_idx and step_cluster of
    # 7 linears: 2 x (4096 + 1024 x 2 + 4096 + 8192 x 2 + 8192) + 2 x
    # (512 x 6 + 1024) bytes)
    "mistral-fsdp-2x2": (40, 9, 28, 2 * 35840),
    # q, k, v gathered; attn wo and FFN wo replicated: their input codes
    "minicpm-1x4": (8, 9, 0, 0),
    # head-sharded caches: no q/k/v gather, no softmax sum; the attention
    # output's codes into wo, wo's output, FFN wo in and out
    "codeqwen-16kv-2x2": (8, 3, 0, 0),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return H.run(tmp_path_factory.mktemp("sharded_serve"), CASES)


@pytest.mark.parametrize("name", CASES)
def test_sharded_bit_equal_to_reference(runs, name):
    out = runs[name]
    H.assert_ranks_equal(out, out["ref"], out["meta"]["cache_blocks"])


@pytest.mark.parametrize("name", CASES)
def test_sharded_bit_equal_to_unsharded(runs, name):
    out = runs[name]
    H.assert_ranks_equal(out, out["plain"], out["meta"]["cache_blocks"])


@pytest.mark.parametrize("name", CASES)
def test_rank_blocks_are_reference_blocks(runs, name):
    """Params as the reference's per-device blocks; ``lm.init_caches(...,
    mesh=)`` makes the blocks ``prefill`` fills."""
    H.assert_param_blocks(runs[name])
    for r in runs[name]["ranks"]:
        shapes = [{b: {k: v.shape for k, v in blk.items()}
                   for b, blk in seg.items()} for seg in r["caches"]]
        assert r["init_caches"] == shapes


@pytest.mark.parametrize("name", CASES)
def test_collectives_per_decode_step(runs, name):
    assert H.step_counts(runs[name]) == PER_STEP[name]


def test_decode_collectives_beside_reference_hlo(runs, capsys):
    """The mistral smoke's decode step on (2, 2): the reference's compiled
    HLO (``hlo_analysis.parse_collectives``, ops in the layer loop counted
    once) beside the port's count on rank 0 (printed with ``-s``).  The
    only parameter collectives are the FSDP gathers."""
    out = runs["mistral-fsdp-2x2"]
    hlo = out["meta"]["hlo"]
    st = out["ranks"][0]["stats"][-1]
    with capsys.disabled():
        print("\ncollectives a decode step, mistral smoke, mesh (2, 2): "
              "kind: reference HLO count/bytes | port count/bytes")
        for k in hlo["count"]:
            print(f"  {k}: {hlo['count'][k]}/{hlo['bytes'][k]} | "
                  f"{st.count_by_kind[k]}/{st.bytes_by_kind[k]}")
        print(f"  port parameter gathers {st.param_count}/{st.param_bytes}")
    assert hlo["count"]["all-reduce"] > 0 and hlo["count"]["all-gather"] > 0
    assert st.param_count == 28
    assert st.count_by_kind["all-gather"] - st.param_count == 12
