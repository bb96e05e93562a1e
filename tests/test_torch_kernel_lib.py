"""The seam every CUDA kernel of the port goes through
(``e4s_tpu_torch/ops/kernel_lib.py``), on the CPU: each library named by its
own source, the build with a stand-in ``nvcc`` (a shell script), the
weight-layout cache and the plain-gradient route. The kernels themselves run
only on a card (``tests/test_torch_cuda.py``)."""

import copy
import pickle
import shutil
import stat

import pytest
import torch

from e4s_tpu_torch.ops import kernel_lib

STEMS = sorted(kernel_lib.sources())

# stands in for nvcc: writes the library named by -o (empty) and a report,
# notes the source it was given, and fails on a source that says FAIL
FAKE_NVCC = """#!/bin/sh
out=
while [ $# -gt 1 ]; do
  if [ "$1" = "-o" ]; then out=$2; fi
  shift
done
echo "$1" >> "$(dirname "$0")/calls"
if grep -q FAIL "$1"; then echo "error: $1 does not compile"; exit 2; fi
echo "ptxas info: compiled $1"
: > "$out"
"""


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the sources under a temporary ``csrc``, built into a
    temporary build directory."""
    src = tmp_path / "csrc"
    shutil.copytree(kernel_lib.CSRC, src)
    monkeypatch.setattr(kernel_lib, "CSRC", src)
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """A fake nvcc under a temporary CUDA_HOME; returns the sources it was
    given, call by call."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    exe = home / "bin" / "nvcc"
    exe.write_text(FAKE_NVCC)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    calls = home / "bin" / "calls"

    def given():
        return sorted(calls.read_text().split()) if calls.exists() else []
    return given


def _paths():
    return {stem: kernel_lib.library_path(stem) for stem in kernel_lib.sources()}


def test_every_kernel_source_is_a_library():
    assert STEMS == ["conv3_n32_f32", "conv3_tf32", "patch_mod_conv3",
                     "patch_mod_conv3_bf16", "styled_conv3_tf32"]
    paths = _paths()
    assert len(set(paths.values())) == len(STEMS)
    for stem, path in paths.items():
        assert path.parent == kernel_lib.BUILD_DIR
        assert path.name.startswith(f"lib{stem}_") and path.suffix == ".so"


@pytest.mark.parametrize("stem", STEMS)
def test_editing_one_source_renames_its_library_alone(csrc, stem):
    before = _paths()
    with open(csrc / f"{stem}.cu", "a") as f:
        f.write("\n// edited\n")
    after = _paths()
    assert after[stem] != before[stem]
    assert {k: v for k, v in after.items() if k != stem} == {
        k: v for k, v in before.items() if k != stem}


def test_a_new_source_is_a_library_that_no_module_names(csrc):
    """A new kernel needs only its source (and its wrapper): it gets its
    own library, the others keep theirs, and the seam names no kernel."""
    before = _paths()
    (csrc / "conv_new.cu").write_text('extern "C" int conv_new() { return 0; }\n')
    after = _paths()
    assert set(after) == set(before) | {"conv_new"}
    assert after["conv_new"] not in before.values()
    assert {k: after[k] for k in before} == before
    text = open(kernel_lib.__file__).read()
    assert not [stem for stem in STEMS if stem in text]


def test_build_compiles_only_the_missing_libraries(csrc, nvcc):
    paths, report = kernel_lib.build()
    assert paths == list(_paths().values())
    assert nvcc() == sorted(str(csrc / f"{s}.cu") for s in STEMS)
    for stem, path in _paths().items():
        assert path.exists()
        assert path.with_suffix(".log").read_text() == (
            f"ptxas info: compiled {csrc / stem}.cu\n")
        assert path.with_suffix(".log").read_text() in report
    assert not list(kernel_lib.BUILD_DIR.glob("*.tmp"))

    kernel_lib.build()  # nothing missing: no compiler run
    assert len(nvcc()) == len(STEMS)

    with open(csrc / "conv3_tf32.cu", "a") as f:
        f.write("\n// edited\n")
    kernel_lib.build()  # the edited source alone
    assert nvcc().count(str(csrc / "conv3_tf32.cu")) == 2
    assert len(nvcc()) == len(STEMS) + 1


def test_build_raises_with_the_failing_sources_report(csrc, nvcc):
    with open(csrc / "patch_mod_conv3.cu", "a") as f:
        f.write("\n// FAIL\n")
    with pytest.raises(RuntimeError, match="patch_mod_conv3.cu does not compile"):
        kernel_lib.build()
    paths = _paths()
    assert not paths["patch_mod_conv3"].exists()
    for stem in set(STEMS) - {"patch_mod_conv3"}:  # the others are built
        assert paths[stem].exists() and paths[stem].with_suffix(".log").exists()


def _params(n=3):
    g = torch.Generator().manual_seed(n)
    return [torch.nn.Parameter(torch.randn(4, generator=g), requires_grad=False)
            for _ in range(n)]


class _Owner:
    pass


@pytest.mark.parametrize("changed", [0, 1, 2])
def test_cached_builds_once_and_again_after_an_in_place_change(changed):
    ps, owner, builds = _params(), _Owner(), []

    def build():
        builds.append(sum(p.sum() for p in ps))
        return builds[-1]

    a = kernel_lib.cached(owner, ps, build)
    assert kernel_lib.cached(owner, ps, build) is a and len(builds) == 1
    with torch.no_grad():
        ps[changed].mul_(2)
    b = kernel_lib.cached(owner, ps, build)
    assert b is not a and len(builds) == 2
    torch.testing.assert_close(b, sum(p.sum() for p in ps))
    ps[changed].data = ps[changed].data.double()  # a new dtype and storage
    assert kernel_lib.cached(owner, ps, build) is not b and len(builds) == 3


def test_cached_builds_per_call_under_grad_or_for_a_temporary():
    ps, owner, builds = _params(), _Owner(), []

    def build():
        builds.append(torch.stack([p.sum() for p in ps]))
        return builds[-1]

    ps[1].requires_grad_(True)
    a = kernel_lib.cached(owner, ps, build)
    assert a.requires_grad  # the gradient flows through the layout
    assert kernel_lib.cached(owner, ps, build) is not a and len(builds) == 2
    with torch.no_grad():  # no gradient wanted: kept
        b = kernel_lib.cached(owner, ps, build)
        assert kernel_lib.cached(owner, ps, build) is b and len(builds) == 3
        ps[1] = ps[1].detach()  # not a Parameter: per call
        assert kernel_lib.cached(owner, ps, build) is not kernel_lib.cached(owner, ps, build)


def test_cached_layouts_are_not_copied():
    ps, owner = _params(), torch.nn.Module()
    owner.w = ps[0]
    kept = kernel_lib.cached(owner, ps, lambda: torch.ones(3))
    assert owner._kernel_cache.value is kept
    for twin in (copy.deepcopy(owner), pickle.loads(pickle.dumps(owner))):
        assert twin._kernel_cache.value is None and twin._kernel_cache.key is None


def test_with_plain_grad_launches_alone_where_no_gradient_is_wanted():
    """No gradient wanted: the launch's own result, outside any Function;
    wanted: the launch's value, with the plain version's gradient (a plain
    version that differs from the launch shows which one ran)."""
    launched = []

    def launch(x, w, packed, flag):
        launched.append((packed, flag))
        return (x * w).detach() + 0

    def plain(x, w):
        return x * w * 3

    x, w = torch.randn(5), torch.randn(5)
    out = kernel_lib.with_plain_grad(launch, plain, (x, w), "packed", True)
    assert out.grad_fn is None and launched == [("packed", True)]
    x.requires_grad_(True)
    with torch.no_grad():
        assert kernel_lib.with_plain_grad(launch, plain, (x, w), "p", 0).grad_fn is None
    out = kernel_lib.with_plain_grad(launch, plain, (x, w), "packed", False)
    torch.testing.assert_close(out, (x * w).detach())
    assert type(out.grad_fn).__name__ == "PlainGradBackward"
    (gx,) = torch.autograd.grad(out.sum(), (x,))
    torch.testing.assert_close(gx, 3 * w)
    assert len(launched) == 3


def test_check_and_check_launch_refuse_what_the_kernel_cannot_take():
    x = torch.zeros(2, 3, 4)
    kernel_lib.check("x", x, (2, 3, 4), x.device, torch.float32)
    with pytest.raises(ValueError, match="shape"):
        kernel_lib.check("x", x, (2, 3, 5), x.device, torch.float32)
    with pytest.raises(TypeError, match="casts nothing"):
        kernel_lib.check("x", x, (2, 3, 4), x.device, torch.bfloat16)
    with pytest.raises(ValueError, match="on cpu"):
        kernel_lib.check("x", x, (2, 3, 4), torch.device("meta"), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        kernel_lib.check("x", x.transpose(0, 1), (3, 2, 4), x.device, torch.float32)
    kernel_lib.check_launch("entry", 0)
    with pytest.raises(RuntimeError, match="entry launch failed: cudaError 700"):
        kernel_lib.check_launch("entry", 700)
