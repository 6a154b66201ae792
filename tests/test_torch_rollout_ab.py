"""``eval/rollout_ab.py`` reads a csrc/ tree's sources before it builds
anything: which file holds each kernel (K1, K3, K2, K4 and K5 in both
forms, K6), its block size where the source exports no occupancy query,
and a launcher that takes other parameters than this checkout's is
refused; ``--tweak`` trees change one launch constant each."""

import re
from pathlib import Path

import pytest

from bluerov2_dynamics_tpu_torch.eval import rollout_ab as ab

CSRC = Path(ab.__file__).resolve().parent.parent / "csrc"

# an older tree: K3 inside window_eval.cu, fixed block sizes, no occupancy export
OLD_ROLLOUT = """constexpr int kThreads = 128;
template <int METHOD> __global__ void rollout_kernel(RowConsts k, int B, int T) {}
int brov2_rollout_final(const void* consts, const float* tau_seq, const float* x0, float* xT,
                        int B, int T, int method, void* stream) { return 0; }
"""
OLD_WINDOW = """constexpr int kThreads = 64;
template <int METHOD, bool USE_LAG, bool PER_TRAJ> __global__ void window_eval_kernel() {}
int brov2_batched_rollout(const void* row_consts, const void* thr_consts, const float* x0,
                          const float* U, float* out, int B, int T, int method,
                          int use_lag, void* stream) { return 0; }
"""

# the K2 of the tree before the fused form: one thread a start, 64 a block
PARENT_WINDOW = """constexpr int kThreads = 64;
template <int METHOD, bool USE_LAG> __global__ void window_eval_kernel() {}
int brov2_window_eval(const void* row_consts, const void* thr_consts, const float* X,
                      const float* U, float* out, int n_start, int H, int method,
                      int use_lag, void* stream) { return 0; }
"""


def _tree(tmp_path, **files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return tmp_path


def test_this_checkout_exports_its_own_occupancy_queries():
    """Every kernel but K6 and the one-block tau prologue has its own query
    (K4's and K5's report the plan at a start count); K6 takes a shim at
    ``kRollThreads``."""
    plan = ab.tree_plan(CSRC)
    assert {k: (v[0].name, v[1], v[2]) for k, v in plan.items()} == {
        "rollout_final": ("rollout.cu", "rollout_kernel<1>", None),
        "shared_tau": ("rollout.cu", "tau_seq_kernel", None),
        "rollout_from_commands": ("rollout.cu", "rollout_commands_kernel<1>", None),
        "batched_rollout": ("batched_rollout.cu", "batched_rollout_kernel<1, true>", None),
        "window_eval": ("window_eval.cu", "window_eval_kernel<0, true>", None),
        "window_eval_wrench": ("window_eval.cu", "window_eval_wrench_kernel<0, false>", None),
        "window_sq_wrench": ("window_eval.cu", "window_eval_wrench_kernel<0, true>", None),
        "window_eval_quat": ("quat.cu", "window_eval_quat_kernel<0, true, false>", None),
        "window_sq_quat": ("quat.cu", "window_eval_quat_kernel<0, true, true>", None),
        "rollout_final_quat": ("quat.cu", "rollout_quat_kernel<1, true>", 128)}


def test_an_older_tree_takes_its_block_sizes_from_the_source(tmp_path):
    tree = _tree(tmp_path, **{"rollout.cu": OLD_ROLLOUT, "window_eval.cu": OLD_WINDOW})
    plan = ab.tree_plan(tree)
    assert plan["rollout_final"][1:] == ("rollout_kernel<1>", 128)
    assert plan["batched_rollout"][0].name == "window_eval.cu"
    assert plan["batched_rollout"][1:] == ("window_eval_kernel<1, true, true>", 64)


def test_a_tree_may_hold_one_kernel(tmp_path):
    tree = _tree(tmp_path, **{"batched_rollout.cu": (CSRC / "batched_rollout.cu").read_text()})
    assert list(ab.tree_plan(tree)) == ["batched_rollout"]


@pytest.mark.parametrize("files,match", [
    ({"rollout.cu": OLD_ROLLOUT.replace("int method, void*", "int method, int block, void*")},
     "takes 9 parameters"),
    ({"rollout.cu": OLD_ROLLOUT.replace("constexpr int kThreads = 128;", "")}, "no kThreads"),
    ({"quat.cu": "int brov2_rollout_final_quat();"}, "holds none of the kernels"),
    ({"window_eval.cu": PARENT_WINDOW.replace("int use_lag, void*", "int use_lag, int lanes, void*")},
     "takes 11 parameters"),
    ({"window_eval.cu": PARENT_WINDOW.replace("constexpr int kThreads = 64;", "")}, "no kThreads"),
    ({"window_eval.cu": PARENT_WINDOW + "int brov2_window_occupancy(int method, int use_lag, "
      "int sq, int lanes, int* lanes_out, int* block, int* blocks_per_sm) {}"},
     "brov2_window_occupancy takes 7 parameters"),
])
def test_an_unknown_tree_is_refused(tmp_path, files, match):
    with pytest.raises(ValueError, match=match):
        ab.tree_plan(_tree(tmp_path, **files))


def test_main_refuses_an_unknown_tree_before_it_needs_a_card(tmp_path):
    with pytest.raises(ValueError, match="holds none of the kernels"):
        ab.main(["--parent", str(tmp_path)])


def test_the_parent_k2_takes_a_shim_at_its_block_size(tmp_path):
    plan = ab.tree_plan(_tree(tmp_path, **{"window_eval.cu": PARENT_WINDOW}))
    assert list(plan) == ["window_eval"]
    assert plan["window_eval"][1:] == ("window_eval_kernel<0, true>", 64)


def test_an_older_window_eval_holds_k2_beside_k3(tmp_path):
    """The tree where window_eval.cu also held K3 (PER_TRAJ): its K2 is the
    three-argument instantiation."""
    text = OLD_WINDOW + PARENT_WINDOW.split("\n", 2)[2]
    plan = ab.tree_plan(_tree(tmp_path, **{"window_eval.cu": text}))
    assert plan["window_eval"][1:] == ("window_eval_kernel<0, true, false>", 64)
    assert plan["batched_rollout"][1:] == ("window_eval_kernel<1, true, true>", 64)


def test_k2_instantiations_name_their_mangled_functions():
    assert ab.mangled_key("window_eval_kernel<0, true>") == "18window_eval_kernelILi0ELb1EE"
    assert ab.mangled_key("window_eval_kernel<0, true, false>") == "18window_eval_kernelILi0ELb1ELb0EE"
    assert ab.KERNELS["window_eval"].window and ab.WINDOW_STARTS == (9_065, 44_800)
    assert ab.H_WINDOW == 100


# the K4 and K5 of the tree before the warp-pair form: one thread a start,
# no occupancy query of their own
PARENT_WRENCH = PARENT_WINDOW + """
template <int METHOD, bool SQ> __global__ void window_eval_wrench_kernel() {}
int brov2_window_eval_wrench(const void* row_consts, const float* X, const float* TAU,
                             float* out, int n_start, int H, int method, void* stream) {}
int brov2_window_sq_wrench(const void* row_consts, const float* X, const float* TAU, float* sq,
                           float* partials, int n_partials, unsigned* ticket, int n_start, int H,
                           int method, void* stream) {}
"""
PARENT_QUAT = """constexpr int kWindowThreads = 64;
constexpr int kRollThreads = 128;
template <int METHOD, bool RENORM, bool SQ> __global__ void window_eval_quat_kernel() {}
template <int METHOD, bool RENORM> __global__ void rollout_quat_kernel() {}
int brov2_window_eval_quat(const void* row_consts, const float* X, const float* TAU,
                           float* out, int n_start, int H, int method, int renormalize,
                           void* stream) {}
int brov2_window_sq_quat(const void* row_consts, const float* X, const float* TAU, float* sq,
                         float* partials, int n_partials, unsigned* ticket, int n_start, int H,
                         int method, int renormalize, void* stream) {}
int brov2_rollout_final_quat(const void* row_consts, const float* TAU, const float* x0,
                             float* xT, int B, int T, int method, int renormalize,
                             void* stream) {}
"""


def test_the_parent_k4_and_k5_take_shims_at_their_own_block_constants(tmp_path):
    """K4's block is window_eval.cu's ``kThreads``; K5's is quat.cu's
    ``kWindowThreads`` and K6's ``kRollThreads``, not a ``kThreads``."""
    plan = ab.tree_plan(_tree(tmp_path, **{"window_eval.cu": PARENT_WRENCH,
                                           "quat.cu": PARENT_QUAT}))
    assert {k: v[1:] for k, v in plan.items()} == {
        "window_eval": ("window_eval_kernel<0, true>", 64),
        "window_eval_wrench": ("window_eval_wrench_kernel<0, false>", 64),
        "window_sq_wrench": ("window_eval_wrench_kernel<0, true>", 64),
        "window_eval_quat": ("window_eval_quat_kernel<0, true, false>", 64),
        "window_sq_quat": ("window_eval_quat_kernel<0, true, true>", 64),
        "rollout_final_quat": ("rollout_quat_kernel<1, true>", 128)}


@pytest.mark.parametrize("files,match", [
    ({"quat.cu": PARENT_QUAT.replace("constexpr int kWindowThreads = 64;", "")},
     "no brov2_window_quat_occupancy and no kWindowThreads"),
    ({"quat.cu": PARENT_QUAT + "int brov2_window_quat_occupancy(int method, int sq, int* plan) {}"},
     "brov2_window_quat_occupancy takes 3 parameters"),
    ({"window_eval.cu": PARENT_WRENCH.replace("int method, void* stream) {}\nint brov2_window_sq",
                                               "int method, int lanes, void* stream) {}\nint brov2_window_sq")},
     "brov2_window_eval_wrench takes 9 parameters"),
])
def test_an_unknown_k4_or_k5_is_refused(tmp_path, files, match):
    with pytest.raises(ValueError, match=match):
        ab.tree_plan(_tree(tmp_path, **files))


def test_pair_kernel_names_the_instantiation_the_plan_picks():
    pair, one = dict(warps=2), dict(warps=1)
    assert ab.pair_kernel("window_eval_wrench", pair) == "window_pair_wrench_kernel<0, false>"
    assert ab.pair_kernel("window_sq_wrench", one) == "window_staged_wrench_kernel<0, true>"
    assert ab.pair_kernel("window_eval_quat", one) == "window_staged_quat_kernel<0, true, false>"
    assert ab.pair_kernel("window_sq_quat", one) == "window_staged_quat_kernel<0, true, true>"
    # each names a kernel template of this checkout's sources
    text = (CSRC / "window_eval.cu").read_text() + (CSRC / "quat.cu").read_text()
    for kernel in ("window_pair_wrench_kernel", "window_staged_wrench_kernel",
                   "window_staged_quat_kernel"):
        assert re.search(rf"\b{kernel}\(RowConsts", text), kernel


def test_every_query_adapter_matches_its_c_signature():
    """``_QUERY_ARGS`` leads each query with as many ints as the C function
    takes before its outputs (two for K1-K3's block and count, one plan
    array for K4's and K5's, which also take the start count)."""
    from bluerov2_dynamics_tpu_torch.ops import _build
    for name, args in ab._QUERY_ARGS.items():
        k = ab.KERNELS[name]
        argtypes = _build._SIGNATURES[k.lib][k.query][0]
        n_out = 1 if name in ab.PLAN_QUERIES else 2
        assert len(argtypes) == len(args) + (name in ab.PLAN_QUERIES) + n_out, name


def test_tweak_tree_changes_one_constant_in_a_copy(tmp_path, monkeypatch):
    """A tweak tree holds the headers and the one source it changes, with
    only the named constants set."""
    monkeypatch.setattr(ab, "AB_DIR", tmp_path)
    tree = ab.tweak_tree("p1", "kWrenchPairs=1,kWrenchSplitStartsPerSm=0")
    assert sorted(f.name for f in tree.iterdir()) == sorted(
        [f.name for f in CSRC.glob("*.cuh")] + ["window_eval.cu"])
    want = re.sub(r"kWrenchPairs = \d+;", "kWrenchPairs = 1;",
                  (CSRC / "window_eval.cu").read_text())
    want = re.sub(r"kWrenchSplitStartsPerSm = \d+;", "kWrenchSplitStartsPerSm = 0;", want)
    assert (tree / "window_eval.cu").read_text() == want
    assert list(ab.tree_plan(tree)) == ["window_eval", "window_eval_wrench", "window_sq_wrench"]
    with pytest.raises(ValueError, match="defined 0 times"):
        ab.tweak_tree("bad", "kNoSuchConstant=3")


# K1 of the tree before the one-call sequence: the prologue kernel and the
# rollout, each with its own launcher
PARENT_ROLLOUT = """constexpr int kBlock = 256;
__global__ void tau_seq_kernel(ThrusterConsts c, const float* U, float* F, float* tau, int T,
                               int use_lag) {}
template <int METHOD> __global__ void rollout_kernel(RowConsts k, int B, int T) {}
int brov2_tau_seq(const void* consts, const float* U, float* F_scratch, float* tau,
                  int T, int use_lag, void* stream) { return 0; }
int brov2_rollout_final(const void* consts, const float* tau_seq, const float* x0, float* xT,
                        int B, int T, int method, void* stream) { return 0; }
int brov2_rollout_occupancy(int method, int* block, int* blocks_per_sm) { return 0; }
"""


def test_a_tree_without_the_one_call_sequence_has_its_prologue_and_rollout(tmp_path):
    """Its U -> xT sequence is then its two launchers (``main`` composes
    them); the prologue has no occupancy query and needs no block constant."""
    plan = ab.tree_plan(_tree(tmp_path, **{"rollout.cu": PARENT_ROLLOUT}))
    assert {k: v[1:] for k, v in plan.items()} == {
        "rollout_final": ("rollout_kernel<1>", None), "shared_tau": ("tau_seq_kernel", None)}
    with pytest.raises(ValueError, match="brov2_tau_seq takes 6 parameters"):
        ab.tree_plan(_tree(tmp_path, **{"rollout.cu": PARENT_ROLLOUT.replace(
            "float* F_scratch, ", "")}))


def test_k1_sequence_and_prologue_name_their_mangled_functions():
    assert ab.mangled_key("tau_seq_kernel") == "14tau_seq_kernel"
    assert ab.mangled_key("rollout_commands_kernel<1>") == "23rollout_commands_kernelILi1EE"
    text = (CSRC / "rollout.cu").read_text()
    assert re.search(r"\btau_seq_kernel\(ThrusterConsts", text)
    assert re.search(r"\brollout_commands_kernel\(RowConsts", text)


def test_a_k1_residency_tweak_holds_all_three_of_its_kernels(tmp_path, monkeypatch):
    monkeypatch.setattr(ab, "AB_DIR", tmp_path)
    tree = ab.tweak_tree("two", "kCommandsMinBlocks=2")
    assert "constexpr int kCommandsMinBlocks = 2;" in (tree / "rollout.cu").read_text()
    assert sorted(f.name for f in tree.iterdir()) == sorted(
        [f.name for f in CSRC.glob("*.cuh")] + ["rollout.cu"])
    assert list(ab.tree_plan(tree)) == ["rollout_final", "shared_tau", "rollout_from_commands"]
