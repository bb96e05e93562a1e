"""The root conftest.py's xdist scheduler: which tests share a work unit under
``--dist loadfile``, and in what order the units leave the queue."""

import importlib.util
import pathlib
import types

ROOT_CONFTEST = pathlib.Path(__file__).resolve().parents[1] / "conftest.py"


def _root_conftest():
    # loaded by path: the module name "conftest" is tests/conftest.py's here
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT_CONFTEST)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _config(dist):
    values = {"dist": dist, "tx": ["popen"]}
    return types.SimpleNamespace(
        getvalue=values.__getitem__,
        option=types.SimpleNamespace(loadscopereorder=True),
    )


class _Log:
    """Stands in for xdist's Producer: any attribute is a sub-log."""

    def __getattr__(self, name):
        return self

    def __call__(self, *args):
        pass


class _Node:
    """Stands in for a worker: records the test indices it is sent."""

    shutting_down = False

    def __init__(self):
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def _scheduler():
    return _root_conftest().pytest_xdist_make_scheduler(
        config=_config("loadfile"), log=_Log()
    )


def test_split_scope():
    scope = _scheduler()._split_scope
    assert (
        scope("tests/test_pipelines.py::test_swap_from_arrays_flag_matrix"
              "[False-True-False]")
        == "tests/test_pipelines.py::test_swap_from_arrays_flag_matrix"
    )
    assert (scope("tests/test_pipelines.py::test_swap_batch")
            == "tests/test_pipelines.py::test_swap_batch")
    assert scope("tests/test_torch_ops.py::test_x[1]") == "tests/test_torch_ops.py"


def test_split_scopes_leave_the_queue_first():
    collection = [
        "tests/test_a.py::test_1",
        "tests/test_a.py::test_2",
        "tests/test_a.py::test_3",
        "tests/test_pipelines.py::test_x",
        "tests/test_pipelines.py::test_m[0]",
        "tests/test_pipelines.py::test_m[1]",
        "tests/test_pipelines.py::test_y",
        "tests/test_b.py::test_1",
        "tests/test_c.py::test_1",
        "tests/test_c.py::test_2",
    ]
    sched, node = _scheduler(), _Node()
    sched.add_node(node)
    sched.add_node_collection(node, collection)
    sched.schedule()
    # finishing each test in turn draws the next units onto the node
    for done in range(len(collection)):
        sched.mark_test_complete(node, node.sent[done])
    assert sched.tests_finished and node.shutting_down
    # split scopes in collection order, then whole files largest first
    assert [collection[i] for i in node.sent] == collection[3:7] + [
        "tests/test_a.py::test_1",
        "tests/test_a.py::test_2",
        "tests/test_a.py::test_3",
        "tests/test_c.py::test_1",
        "tests/test_c.py::test_2",
        "tests/test_b.py::test_1",
    ]


def test_other_dist_modes_keep_xdist_scheduler():
    hook = _root_conftest().pytest_xdist_make_scheduler
    for dist in ("load", "no"):
        assert hook(config=_config(dist), log=_Log()) is None
