"""The modules tpullama_torch copies from the JAX package (the port imports
nothing of it) behave like the originals on the tiny fixtures: HParams,
GGUF reader tensors and writer bytes, block dequantization, repacked and
transposed planes byte for byte, tokenize/detokenize, and the host
sampler chain. All comparisons are exact: the copies run the same numpy
code."""

import numpy as np
import pytest

from tpullama import gguf as j_gguf
from tpullama.gguf import GGMLType
from tpullama.models.hparams import HParams as JHParams
from tpullama.models.testing import make_tiny_llama_gguf
from tpullama.ops import qweights as j_qw
from tpullama.runtime import sampling as j_sampling
from tpullama.tokenizer import Vocab as JVocab
from tpullama_torch import gguf as t_gguf
from tpullama_torch.models.hparams import HParams as THParams
from tpullama_torch.ops import qweights as t_qw
from tpullama_torch.runtime import sampling as t_sampling
from tpullama_torch.tokenizer import Vocab as TVocab

ARCHS = ["llama", "qwen2", "mistral", "chatglm"]
PACKED = sorted(j_qw.PACKED_TYPES, key=lambda t: t.value)
TEXTS = ["Once upon a time", "  two  spaces\tand a tab\n", "bytes: é中\U0001F600",
         "<s> literal special", ""]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    paths = {}
    for arch in ARCHS:
        p = str(tmp_path_factory.mktemp(arch) / "m.gguf")
        make_tiny_llama_gguf(p, arch=arch, qtype=GGMLType.Q4_K, n_embd=256, n_ff=256,
                             seed=5)
        paths[arch] = p
    return paths


@pytest.mark.parametrize("arch", ARCHS)
def test_hparams_equal(tiny, arch):
    j = JHParams.from_gguf(j_gguf.GGUFReader(tiny[arch]))
    t = THParams.from_gguf(t_gguf.GGUFReader(tiny[arch]))
    # the port copies the llama family's fields; each must equal the original's
    assert vars(t) == {k: getattr(j, k) for k in vars(t)}


@pytest.mark.parametrize("arch", ["gemma", "mamba", "bert"])
def test_hparams_refuse_other_archs(tmp_path, arch):
    p = str(tmp_path / "m.gguf")
    make_tiny_llama_gguf(p, arch=arch, n_embd=64, n_ff=128, seed=5)
    JHParams.from_gguf(j_gguf.GGUFReader(p))  # the original reads it
    with pytest.raises(NotImplementedError, match=arch):
        THParams.from_gguf(t_gguf.GGUFReader(p))


@pytest.mark.parametrize("arch", ARCHS)
def test_reader_tensors_equal(tiny, arch):
    rj = j_gguf.GGUFReader(tiny[arch])
    rt = t_gguf.GGUFReader(tiny[arch])
    assert list(rt.tensors) == list(rj.tensors)
    assert set(rt.kv) == set(rj.kv)
    for name, info in rj.tensors.items():
        ti = rt.tensors[name]
        assert (ti.shape, int(ti.ggml_type)) == (info.shape, int(info.ggml_type))
        np.testing.assert_array_equal(rt.tensor_raw(name), rj.tensor_raw(name))


def test_reader_bytes_source(tiny):
    data = open(tiny["llama"], "rb").read()
    rt = t_gguf.GGUFReader(data)
    rj = j_gguf.GGUFReader(tiny["llama"])
    name = "blk.0.attn_q.weight"
    np.testing.assert_array_equal(rt.tensor_raw(name), rj.tensor_raw(name))


@pytest.mark.parametrize("qtype", [GGMLType.F32, GGMLType.F16, GGMLType.BF16],
                         ids=lambda t: t.name)
def test_writer_bytes_equal(tmp_path, qtype):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((8, 64)).astype(np.float32)
    out = []
    for mod in (j_gguf, t_gguf):
        g = mod.GGUFWriter()
        g.add_str("general.architecture", "llama")
        g.add_u32("llama.block_count", 1)
        g.add_array("tokenizer.ggml.tokens", ["a", "b"])
        g.add_tensor("w", w, qtype)
        g.add_tensor("raw", (2, 256), GGMLType.Q4_K,
                     raw=np.arange(2 * 144, dtype=np.uint8))
        p = tmp_path / f"{mod.__name__}.gguf"
        g.write(str(p))
        out.append(p.read_bytes())
    assert out[0] == out[1]


@pytest.mark.parametrize("qtype", [GGMLType.F32, GGMLType.F16, GGMLType.BF16,
                                   GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
def test_dequantize_equal(qtype):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4, 256)).astype(np.float32)
    raw = j_gguf.quantize(w, qtype)
    np.testing.assert_array_equal(t_gguf.dequantize(raw, qtype, w.shape),
                                  j_gguf.dequantize(raw, qtype, w.shape))


def _raw(qtype, n_out, n_in, seed=3):
    """Block bytes: the codec's quantizer where the JAX package has one,
    else random bytes with finite fp16 scales."""
    rng = np.random.default_rng(seed)
    if qtype in (GGMLType.Q2_K, GGMLType.Q3_K):
        traits = j_gguf.GGML_TYPE_TRAITS[qtype]
        raw = rng.integers(0, 256, n_out * n_in // traits.block_size * traits.type_size,
                           dtype=np.uint8)
        blocks = raw.reshape(-1, traits.type_size)
        # the fp16 d / dmin sit at the block's end: clear their exponent's top bit
        blocks[:, -1] &= 0x3F
        if qtype == GGMLType.Q2_K:
            blocks[:, -3] &= 0x3F
        return raw
    return j_gguf.quantize(rng.standard_normal((n_out, n_in)).astype(np.float32), qtype)


@pytest.mark.parametrize("qtype", PACKED, ids=lambda t: t.name)
def test_repacked_planes_equal(qtype):
    n_out, n_in = 8, 512
    raw = _raw(qtype, n_out, n_in)
    pj = j_qw.repack(raw, qtype, (n_out, n_in))
    pt = t_qw.repack(raw, qtype, (n_out, n_in))
    assert (pt.group, pt.shape, list(pt.fields)) == (pj.group, pj.shape, list(pj.fields))
    for k in pj.fields:
        assert pt.fields[k].dtype == pj.fields[k].dtype
        np.testing.assert_array_equal(pt.fields[k], pj.fields[k])
    np.testing.assert_array_equal(t_qw.dequant_planar_np(pt), j_qw.dequant_planar_np(pj))


def test_group_permute_equal():
    v = np.arange(3 * 128).reshape(3, 128)
    for g in (16, 32):
        np.testing.assert_array_equal(t_qw.group_permute(v, g), j_qw.group_permute(v, g))
        np.testing.assert_array_equal(t_qw.group_unpermute(v, g), j_qw.group_unpermute(v, g))
    for bits in (1, 2, 4):
        packed = j_qw._stripe_pack(v % (1 << bits), bits)
        np.testing.assert_array_equal(t_qw._stripe_pack(v % (1 << bits), bits), packed)
        np.testing.assert_array_equal(t_qw.stripe_unpack_np(packed, bits),
                                      j_qw.stripe_unpack_np(packed, bits))


@pytest.mark.parametrize("K", [256, 4096])
def test_fourblock_functions_equal(K):
    """fourblock_permute / _unpermute / _scale_perm, to_fourblock of a Q4_K
    repack, and dequant_planar_np of its fourblock planes: byte for byte
    the reference's (K = 256 gives the smallest R = K/128)."""
    v = np.arange(3 * K).reshape(3, K)
    for g in (16, 32):
        np.testing.assert_array_equal(t_qw.fourblock_permute(v, g), j_qw.fourblock_permute(v, g))
        np.testing.assert_array_equal(t_qw.fourblock_unpermute(v, g),
                                      j_qw.fourblock_unpermute(v, g))
        np.testing.assert_array_equal(t_qw.fourblock_scale_perm(K, g),
                                      j_qw.fourblock_scale_perm(K, g))
    raw = _raw(GGMLType.Q4_K, 8, K)
    fj = j_qw.to_fourblock(j_qw.repack(raw, GGMLType.Q4_K, (8, K)))
    ft = t_qw.to_fourblock(t_qw.repack(raw, GGMLType.Q4_K, (8, K)))
    layout = (ft.order, ft.group, ft.shape, list(ft.fields))
    assert layout == (fj.order, fj.group, fj.shape, list(fj.fields))
    assert layout == ("fourblock", 32, (8, K), ["q4", "scale", "minv"])
    for k in fj.fields:
        assert ft.fields[k].dtype == fj.fields[k].dtype
        np.testing.assert_array_equal(ft.fields[k], fj.fields[k])
    np.testing.assert_array_equal(t_qw.dequant_planar_np(ft), j_qw.dequant_planar_np(fj))
    np.testing.assert_array_equal(t_qw.dequant_planar_np(ft),
                                  j_gguf.dequantize(raw, GGMLType.Q4_K, (8, K)).reshape(8, K))
    with pytest.raises(ValueError, match="fourblock unsupported"):
        t_qw.to_fourblock(t_qw.repack(_raw(GGMLType.Q6_K, 8, K), GGMLType.Q6_K, (8, K)))


@pytest.mark.parametrize("n_in", [256, 14336], ids=["8-groups", "448-groups"])
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_transpose_planes_equal(qtype, n_in):
    """Expert planes (E, rows, kcols) -> (E, kcols, rows), scale/minv group
    rows zero-padded to 16 (8 groups pad to 16; 448 need none)."""
    raw = _raw(qtype, 2 * 128, n_in)
    fields = {k: v.reshape(2, 128, -1) for k, v in j_qw.repack(raw, qtype, (256, n_in)).fields.items()}
    tj, tt = j_qw.transpose_planes(fields), t_qw.transpose_planes(fields)
    assert list(tt) == list(tj)
    for k in tj:
        assert tt[k].dtype == tj[k].dtype and tt[k].flags.c_contiguous
        np.testing.assert_array_equal(tt[k], tj[k])
    assert tt["scale"].shape[1] == -(-(n_in // 32) // 16) * 16


@pytest.mark.parametrize("text", TEXTS)
def test_tokenize_detokenize_equal(tiny, text):
    vj = JVocab.from_gguf(j_gguf.GGUFReader(tiny["llama"]))
    vt = TVocab.from_gguf(t_gguf.GGUFReader(tiny["llama"]))
    for add_special in (True, False):
        ids = vj.tokenize(text, add_special=add_special)
        assert vt.tokenize(text, add_special=add_special) == ids
        assert vt.detokenize(ids) == vj.detokenize(ids)
        assert [vt.token_to_piece(i, special=False) for i in ids] == \
               [vj.token_to_piece(i, special=False) for i in ids]
    assert [vt.is_eog(i) for i in range(vt.n_tokens)] == [vj.is_eog(i) for i in range(vj.n_tokens)]


@pytest.mark.parametrize("kw", [
    dict(temp=0.0),
    dict(seed=11, temp=0.8),
    dict(seed=12, temp=1.2, top_k=5, top_p=0.9, min_p=0.0, penalty_repeat=1.3),
    dict(seed=13, temp=0.7, mirostat=2),
    dict(seed=14, temp=0.9, typical_p=0.8, xtc_probability=0.5, xtc_threshold=0.05),
], ids=["greedy", "default", "topk-penalty", "mirostat2", "typical-xtc"])
def test_sampler_chain_equal(kw):
    rng = np.random.default_rng(4)
    logits = [rng.standard_normal(300).astype(np.float32) * 3 for _ in range(24)]
    cj = j_sampling.SamplerChain.from_params(**kw)
    ct = t_sampling.SamplerChain.from_params(**kw)
    assert [ct.sample(x) for x in logits] == [cj.sample(x) for x in logits]
