"""The work counts against counts made by hand."""
import pytest

from servebench.harness import registry

M = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
     "head_dim": 2, "d_ff": 16, "vocab_size": 10, "block_kind": "dense"}


def test_model_step_flops():
    ms = registry.roofline("model_step")
    # per layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8, MLP 3 x 8x16 = 576
    assert ms.token_params(M) == 2 * 576
    assert ms.head_params(M) == 80
    # one row over 5 keys: 2 x (1152 + 80) + QK and PV 4 x 2 x 4 x 2 x 5
    assert ms.decode(M, [5]) == 2 * 1232 + 320
    assert ms.decode(M, [5, 1]) == 2 * (2 * 1232) + 320 + 64
    # 3 tokens after 2 cached: keys 3 + 4 + 5 = 12
    assert ms.chunk(M, 2, 3) == 2 * 1152 * 3 + 2 * 80 + 64 * 12
    moe = {**M, "block_kind": "moe", "n_experts": 4, "top_k": 2}
    # router 8x4 and two experts of 3 x 8x16 instead of the MLP
    assert ms.token_params(moe) == 2 * (192 + 32 + 2 * 384)


def test_kernel_work():
    pd = registry.roofline("paged_decode_attention")
    # rows of 3 and 5 keys, bf16: K and V of 2 heads x 2 dims each key,
    # the query and output of 4 heads x 2 dims each row, per layer
    f, b = pd.work(M, [3, 5], 2)
    assert f == 4 * 2 * 4 * 8 * 2
    assert b == (2 * 8 * 2 * 2 + 2 * 2 * 4 * 2) * 2 * 2
    fp = registry.roofline("flash_prefill")
    f, b = fp.work(M, 4, 2)
    assert f == 2 * 2 * 4 * (4 * 5) * 2          # QK and PV, 10 pairs each
    assert b == (2 * 4 * 8 + 2 * 4 * 4) * 2 * 2
    fc = registry.roofline("flash_prefill_chunk")
    assert fc.work(M, 0, 4, 2)[0] == f           # a chunk from 0: a prompt
    f, b = fc.work(M, 6, 2, 2)                   # keys 7 + 8
    assert f == 4 * 2 * 4 * 15 * 2
    assert b == (2 * 2 * 8 + 2 * 8 * 4) * 2 * 2


@pytest.mark.parametrize("kernel,name,hit", [
    ("paged_decode_attention",
     "void split_attn::split_tc_kernel<128, 16>(split_attn::Args)", True),
    ("paged_decode_attention", "void split_attn::combine_kernel<128>(x)",
     True),
    ("flash_prefill", "void (anonymous namespace)::tc::kernel<128, 4>"
     "(CUtensorMap, CUtensorMap, (anonymous namespace)::Args)", True),
    ("flash_prefill", "void (anonymous namespace)::tc::gate_up<64>(x)",
     False),
    ("moe_grouped_ffn", "void (anonymous namespace)::tc::gate_up<64>(x)",
     True),
    ("moe_grouped_ffn", "void (anonymous namespace)::tc::down<64>(x)", True),
    ("moe_grouped_ffn", "(anonymous namespace)::tc::gate_up(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*, int const*, float*, int)", True),
    ("flash_prefill", "void (anonymous namespace)::tc::kernel<128>"
     "(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Args)", True),
    ("paged_decode_attention", "void split_attn::combine_kernel<(anonymous "
     "namespace)::PagedKeys, __nv_bfloat16, 128>(split_attn::Args)", True),
])
def test_kernel_names(kernel, name, hit):
    assert bool(registry.roofline(kernel).KERNEL.search(name)) == hit
