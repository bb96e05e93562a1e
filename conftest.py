"""Root pytest configuration: how pytest-xdist hands out tests under
``--dist loadfile``.

Only the standard library and pytest are imported here: this file sits above
``benchmark/tests/`` too, whose tests check what the benchmark imports.
"""

import pytest

# Files whose tests go out one test function at a time instead of as one
# whole file. Each test of tests/test_pipelines.py builds its own FaceSwapper
# and compiles its own JAX programs: alone on an 8-core CPU host the file
# takes about 1580 s, and whole under -n 6 it held one worker past the
# suite's 1470 s limit while the other five finished every other file in
# about 600 s. No other file takes more than about 300 s of a worker's time.
SPLIT_FILES = ("tests/test_pipelines.py",)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """Under ``--dist loadfile``, split SPLIT_FILES into one scope per test
    function and hand those scopes out first; other modes keep xdist's own."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitFileScheduling(LoadFileScheduling):
        _split_first = False

        def _split_scope(self, nodeid):
            path = nodeid.split("::", 1)[0]
            # the cases of one parametrised test stay together
            return nodeid.split("[", 1)[0] if path in SPLIT_FILES else path

        def _assign_work_unit(self, node):
            # xdist queues the largest scopes first, which would send the
            # one-test scopes, the longest units, out last. Move them to the
            # head once, in collection order, before the first hand-out.
            if not self._split_first:
                self._split_first = True
                scopes = dict.fromkeys(map(self._split_scope, self.collection))
                for scope in reversed([s for s in scopes if "::" in s]):
                    self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return SplitFileScheduling(config, log)
