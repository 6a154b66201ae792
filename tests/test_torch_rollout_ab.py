"""``eval/rollout_ab.py`` reads a csrc/ tree's K1/K3/K2 sources before it
builds anything: which file holds each kernel, its block size where the
source exports no occupancy query, and a launcher that takes other
parameters than this checkout's is refused."""

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
    plan = ab.tree_plan(CSRC)
    assert {k: (v[0].name, v[1], v[2]) for k, v in plan.items()} == {
        "rollout_final": ("rollout.cu", "rollout_kernel<1>", None),
        "batched_rollout": ("batched_rollout.cu", "batched_rollout_kernel<1, true>", None),
        "window_eval": ("window_eval.cu", "window_eval_kernel<0, true>", None)}


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
    assert ab._key("window_eval_kernel<0, true>") == "18window_eval_kernelILi0ELb1EE"
    assert ab._key("window_eval_kernel<0, true, false>") == "18window_eval_kernelILi0ELb1ELb0EE"
    assert ab.KERNELS["window_eval"][5] == (9_065, 44_800) and ab.H_WINDOW == 100
