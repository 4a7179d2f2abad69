"""Differential tests of K1's plain version (pilosa_tpu_torch.ops.count_expr)
against the TPU package: the Pallas `count_expr_stack` run in interpret
mode (as tests/test_pallas.py runs it on the CPU) for op chains, and
`StackedEvaluator._tree_eval` + popcount for nested trees. Tolerance:
exact integer equality (both sides count bits exactly).

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py holds
it against this plain version there.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pilosa_tpu.exec.stacked import StackedEvaluator  # noqa: E402
from pilosa_tpu.ops import pallas_kernels as pk  # noqa: E402
from pilosa_tpu.parallel.sharded import QueryKernels as JaxKernels  # noqa: E402
from pilosa_tpu.shardwidth import WORDS_PER_ROW  # noqa: E402
from pilosa_tpu_torch.ops import count_expr as k1  # noqa: E402
from pilosa_tpu_torch.parallel.sharded import QueryKernels  # noqa: E402

EDGE_WORDS = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x00000001, 0],
                      dtype=np.uint32)


def _stack(rng, s):
    """Random [S, W] uint32 stack with the edge words planted in row 0..."""
    x = rng.integers(0, 1 << 32, (s, WORDS_PER_ROW), dtype=np.uint32)
    if s:
        x[:, :len(EDGE_WORDS)] = EDGE_WORDS
        x[s // 2, -1] = 0x80000000
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _numpy_count(sig, stacks):
    def ev(node):
        if node[0] == "leaf":
            return stacks[node[1]]
        op, subs = node
        acc = ev(subs[0])
        for sub in subs[1:]:
            p = ev(sub)
            acc = {"&": acc & p, "|": acc | p, "^": acc ^ p,
                   "-": acc & ~p}[op]
        return acc
    return int(np.bitwise_count(ev(sig)).sum(dtype=np.int64))


CHAINS = [("&",), ("|",), ("^",), ("-",), ("&", "|"), ("|", "-", "^"),
          ("-", "&", "^", "|", "&")]


@pytest.mark.parametrize("s", [0, 1, 16, 17])
@pytest.mark.parametrize("ops", CHAINS, ids=["".join(o) for o in CHAINS])
def test_plain_k1_matches_pallas_chain(s, ops):
    rng = np.random.default_rng(len(ops) * 100 + s)
    planes = [_stack(rng, s) for _ in range(len(ops) + 1)]
    want = int(pk.count_expr_stack(planes[0], planes[1:], ops))
    got = k1.count_expr_stack(_t(planes[0]), [_t(p) for p in planes[1:]],
                              ops)
    assert got.dtype == torch.int64
    assert int(got) == want


@pytest.mark.parametrize("word", [0xFFFFFFFF, 0x80000000, 0x55555555, 1])
def test_plain_k1_edge_words_exact(word):
    a = np.full((3, WORDS_PER_ROW), word, dtype=np.uint32)
    b = np.full((3, WORDS_PER_ROW), 0xFFFFFFFF, dtype=np.uint32)
    want = int(pk.count_intersect_stack(a, b))
    assert want == 3 * WORDS_PER_ROW * bin(word).count("1")
    assert int(k1.count_expr_stack(_t(a), [_t(b)], ("&",))) == want


NESTED = [
    ("|", (("&", (("leaf", 0), ("leaf", 1))),
           ("-", (("leaf", 2), ("leaf", 3))))),
    ("^", (("leaf", 0), ("|", (("leaf", 1), ("&", (("leaf", 2),
                                                   ("leaf", 3))))))),
    ("-", (("leaf", 3), ("&", (("leaf", 0), ("leaf", 1), ("leaf", 2))))),
    ("&", (("leaf", 1),)),
    ("leaf", 2),
]


@pytest.mark.parametrize("sig", NESTED, ids=[str(i) for i in range(len(NESTED))])
@pytest.mark.parametrize("s", [1, 7])
def test_plain_k1_matches_tree_eval(sig, s):
    rng = np.random.default_rng(7 + s)
    planes = [_stack(rng, s) for _ in range(4)]
    acc = StackedEvaluator._tree_eval(sig, [jax.numpy.asarray(p)
                                            for p in planes])
    want = int(np.sum(np.asarray(jax.lax.population_count(acc)),
                      dtype=np.int64))
    assert want == _numpy_count(sig, planes)
    assert int(k1.count_expr(sig, [_t(p) for p in planes])) == want


def test_query_kernels_match_jax():
    rng = np.random.default_rng(5)
    planes = [_stack(rng, 3) for _ in range(3)]
    want = JaxKernels.count_expr(planes, "&|")
    assert QueryKernels.count_expr([_t(p) for p in planes], "&|") == want
    assert QueryKernels.count_intersect(_t(planes[0]), _t(planes[1])) \
        == JaxKernels.count_intersect(planes[0], planes[1])


def test_program_compilation():
    sig = NESTED[0]
    # postfix: L0 L1 & L2 L3 -  |
    assert k1.compile_program(sig) == bytes([0, 1, 16, 2, 3, 19, 17])
    assert k1.compile_program(k1.chain_signature(3, "&^")) \
        == bytes([0, 1, 16, 2, 18])
    deep = ("leaf", 0)
    for i in range(1, 9):  # right-nested: needs stack depth 9
        deep = ("&", (("leaf", 0), deep))
    with pytest.raises(ValueError, match="stack depth"):
        k1.compile_program(deep)
    with pytest.raises(ValueError, match="leaf slot"):
        k1.compile_program(("leaf", 16))
    with pytest.raises(ValueError, match="op chain"):
        k1.chain_signature(3, "&")


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((2, WORDS_PER_ROW), dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        k1.count_expr(("leaf", 0), [a.to(torch.int64)])
    with pytest.raises(ValueError, match="shape"):
        k1.count_expr(("&", (("leaf", 0), ("leaf", 1))), [a, a[:1]])
    with pytest.raises(ValueError, match="no stack"):
        k1.count_expr(("&", (("leaf", 0), ("leaf", 1))), [a])
    assert k1.count_expr.launches == 0  # CPU tensors never launch


# --------------------------------------------------- K1's batched entry


def _jax_count(sig, planes):
    """The TPU package's count of one member: Pallas `count_expr_stack`
    in interpret mode for a chain, `_tree_eval` + popcount otherwise."""
    acc = StackedEvaluator._tree_eval(sig, [jax.numpy.asarray(p)
                                            for p in planes])
    return int(np.sum(np.asarray(jax.lax.population_count(acc)),
                      dtype=np.int64))


BATCH_SIGS = {
    "chain_and": k1.chain_signature(2, "&"),
    "chain_mixed": k1.chain_signature(4, "|-^"),
    "tree": NESTED[0],
    "leaf": ("leaf", 0),
    # 17 slots: past K1's limit, fitted per member first
    "union_17": ("|", tuple(("leaf", i) for i in range(17))),
}


@pytest.mark.parametrize("b", [1, 2, 3, 5, 17])
@pytest.mark.parametrize("name", sorted(BATCH_SIGS))
def test_batch_reference_matches_jax_per_member(name, b):
    sig = BATCH_SIGS[name]
    n = max(k1._leaf_slots(sig, {})) + 1
    rng = np.random.default_rng(b * 31 + n)
    pool = [_stack(rng, 3) for _ in range(n + 2)]
    # members share some leaves and not others
    members = [[pool[(q + i) % len(pool)] for i in range(n)]
               for q in range(b)]
    want = [_jax_count(sig, m) for m in members]
    if name == "chain_and":
        want_pallas = [int(pk.count_expr_stack(m[0], m[1:], ("&",)))
                       for m in members]
        assert want_pallas == want
    stacks = [[_t(p) for p in m] for m in members]
    ref = k1.count_expr_batch_reference(sig, stacks)
    got = k1.count_expr_batch(sig, stacks)
    assert ref.dtype == got.dtype == torch.int64
    assert ref.shape == got.shape == (b,)
    assert ref.tolist() == got.tolist() == want
    assert k1.count_expr_batch.launches == 0  # CPU tensors never launch


def test_batch_empty_stacks_and_mismatched_members():
    sig = k1.chain_signature(2, "&")
    empty = torch.zeros((0, WORDS_PER_ROW), dtype=torch.int32)
    assert k1.count_expr_batch(sig, [[empty, empty]] * 3).tolist() \
        == [0, 0, 0]
    a = torch.zeros((2, WORDS_PER_ROW), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        k1.count_expr_batch(sig, [[a, a], [a[:1], a[:1]]])
    with pytest.raises(ValueError, match="shape"):
        k1.count_expr_batch(sig, [[a, a], [a, a[:1]]])
    with pytest.raises(TypeError, match="dtype"):
        k1.count_expr_batch(sig, [[a, a], [a.to(torch.int64)] * 2])
    with pytest.raises(ValueError, match="no stack"):
        k1.count_expr_batch(sig, [[a, a], [a]])
    with pytest.raises(ValueError, match="at least one member"):
        k1.count_expr_batch(sig, [])
    assert k1.count_expr_batch.launches == 0


# ------------------------------------------------- K1's multi-tree entry


MULTI_SIGS = [BATCH_SIGS[k] for k in sorted(BATCH_SIGS)] + NESTED


def _multi_members(rng, n, s):
    """n members cycling through every signature kind (chain, tree, a
    single leaf, a 17-slot Union past K1's limits), drawing their leaves
    from one small pool so neighbours share some leaves."""
    pool = [_stack(rng, s) for _ in range(20)]
    sigs, members = [], []
    for q in range(n):
        sig = MULTI_SIGS[q % len(MULTI_SIGS)]
        slots = max(k1._leaf_slots(sig, {})) + 1
        sigs.append(sig)
        members.append([pool[(3 * q + i) % len(pool)] for i in range(slots)])
    return sigs, members


@pytest.mark.parametrize("n", [1, 2, 5, 17])
def test_multi_reference_matches_jax_per_member(n):
    """count_expr_multi (the plain version on the CPU) and
    count_expr_multi_reference against the TPU package, member by
    member: Pallas `count_expr_stack` in interpret mode for each chain
    member, its `_tree_eval` + popcount for the others. Exact."""
    rng = np.random.default_rng(700 + n)
    sigs, members = _multi_members(rng, n, 3)
    want = []
    for sig, m in zip(sigs, members):
        want.append(_jax_count(sig, m))
        chain = sig[0] != "leaf" and len(sig[1]) == 2 \
            and all(c[0] == "leaf" for c in sig[1])
        if chain:
            assert int(pk.count_expr_stack(m[0], m[1:], (sig[0],))) == \
                want[-1]
    stacks = [[_t(p) for p in m] for m in members]
    ref = k1.count_expr_multi_reference(sigs, stacks)
    got = k1.count_expr_multi(sigs, stacks)
    assert ref.dtype == got.dtype == torch.int64
    assert ref.shape == got.shape == (n,)
    assert ref.tolist() == got.tolist() == want
    assert k1.count_expr_multi.launches == 0  # CPU tensors never launch


def test_multi_empty_stacks_and_bad_members():
    sigs = [k1.chain_signature(2, "&"), ("leaf", 0), NESTED[0]]
    empty = torch.zeros((0, WORDS_PER_ROW), dtype=torch.int32)
    assert k1.count_expr_multi(
        sigs, [[empty, empty], [empty], [empty] * 4]).tolist() == [0, 0, 0]
    a = torch.zeros((2, WORDS_PER_ROW), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        k1.count_expr_multi(sigs[:2], [[a, a], [a[:1]]])
    with pytest.raises(TypeError, match="dtype"):
        k1.count_expr_multi(sigs[:2], [[a, a], [a.to(torch.int64)]])
    with pytest.raises(ValueError, match="no stack"):
        k1.count_expr_multi(sigs[:1], [[a]])
    with pytest.raises(ValueError, match="signatures"):
        k1.count_expr_multi(sigs, [[a, a]])
    with pytest.raises(ValueError, match="at least one member"):
        k1.count_expr_multi([], [])
    assert k1.count_expr_multi.launches == 0


def test_multi_program_table_layout():
    """MultiProgram's table: per member (code offset, code length, leaf
    offset, leaf count, chain flag) as int32, then the postfix codes —
    what csrc/count_expr.cu's count_multi_kernel reads. The chain flag
    follows the kernel's is_chain; a fitted 17-slot member comes back
    within the limits."""
    rng = np.random.default_rng(5)
    sigs, members = _multi_members(rng, 6, 1)
    fitted = [k1.fit_tree(sig, [_t(p) for p in m])
              for sig, m in zip(sigs, members)]
    fsigs = [f[0] for f in fitted]
    counts = [len(f[1]) for f in fitted]
    assert max(counts) <= k1.MAX_LEAVES
    prog = k1.MultiProgram().bind(fsigs, counts)
    host = prog.host.numpy()
    d = k1.MULTI_DESC
    desc = host[:d * len(fsigs)].reshape(len(fsigs), d)
    codes = host[d * len(fsigs):].tobytes()
    leaf_off = code_off = 0
    for row, sig, n in zip(desc, fsigs, counts):
        code = k1.compile_program(sig)
        assert list(row) == [code_off, len(code), leaf_off, n,
                             int(k1._is_chain(code))]
        assert codes[code_off:code_off + len(code)] == code
        code_off += len(code)
        leaf_off += n
    assert len(codes) == code_off + (-code_off % 4)
    # the same signatures rebind nothing; others rebuild the table
    assert prog.bind(fsigs, counts).host is prog.host
    old = prog.host
    assert prog.bind(fsigs[:2], counts[:2]).host is not old
    assert k1._is_chain(k1.compile_program(k1.chain_signature(3, "&|")))
    assert not k1._is_chain(k1.compile_program(NESTED[0]))
    with pytest.raises(ValueError, match="leaves"):
        k1.MultiProgram().bind([("leaf", 0)], [0])


def test_ab_k1_shapes_bound_by_the_declared_costs():
    """tools/ab_k1.py's shape table and the bytes it bounds each call by
    equal the wrappers' declared costs (count_expr_cost,
    count_expr_batch_cost, count_expr_multi_cost) at every shape, and
    cover each entry and one part's shape on a node of 1, 2, 4 and 8
    cards."""
    from pilosa_tpu_torch.tools import ab_k1

    for shape in ab_k1.SHAPES:
        _, entry, n, s, b = shape
        sigs = ab_k1.signatures(shape)
        assert len(sigs) == b
        assert all(max(k1._leaf_slots(g, {})) + 1 == n for g in sigs)
        cost = {"single": lambda: k1.count_expr_cost(n, s, WORDS_PER_ROW),
                "batch": lambda: k1.count_expr_batch_cost(
                    b, n, s, WORDS_PER_ROW),
                "multi": lambda: k1.count_expr_multi_cost(
                    [n] * b, s, WORDS_PER_ROW)}[entry]()
        assert ab_k1.shape_bytes(shape, WORDS_PER_ROW) \
            == cost["bytes accessed"], shape
    assert {sh[1] for sh in ab_k1.SHAPES} == {"single", "batch", "multi"}
    assert [sh[3] for sh in ab_k1.SHAPES if sh[0].startswith("chain")] \
        == [954, 477, 239, 120]


def test_ab_k1_imports_without_cuda_or_jax():
    """The A/B tool imports on a machine with no card and no JAX: in a
    fresh interpreter with no visible card it loads no jax, jaxlib or
    pilosa_tpu module."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import pilosa_tpu_torch.tools.ab_k1 as m\n"
            "assert len(m.SHAPES) == 8\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', "
            "'pilosa_tpu'))\n"
            "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=repo, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
