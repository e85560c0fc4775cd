"""The port's static-analysis package (``dmtpu check`` over
``distributedmandelbrot_tpu_torch``), under the JAX package's own tests
of its analysis package, with the ``jax`` family's tests replaced by the
``torch`` family's, and held against the reference on planted projects.

Every rule id gets at least one firing fixture and one clean fixture,
plus engine behavior: inline suppressions, baseline matching (including
stale entries), the JSON report schema, and parse-error reporting.
All fixtures go through ``Project.from_sources`` — no disk, no torch.
"""

from __future__ import annotations

import json
import re

import pytest

from distributedmandelbrot_tpu_torch import analysis
from distributedmandelbrot_tpu_torch.analysis import (Project, all_rules,
                                                check_project, run_check)

P = "distributedmandelbrot_tpu_torch"


def findings_for(sources: dict[str, str], rule: str) -> list:
    project = Project.from_sources(sources)
    return [f for f in check_project(project) if f.rule == rule]


# -- catalogue -------------------------------------------------------------

def test_rule_catalogue_covers_all_families():
    rules = all_rules()
    families = {r.family for r in rules.values()}
    assert {"locks", "async", "wire", "torch", "engine",
            "proto", "res", "obs", "fsm"} <= families
    for rule in rules.values():
        assert rule.severity in ("error", "warning")
        assert rule.doc


def test_unknown_rule_id_rejected():
    with pytest.raises(ValueError, match="unknown rule ids"):
        check_project(Project.from_sources({}), ["no-such-rule"])


def test_rules_accept_family_names():
    ids = analysis.expand_rule_ids(["proto", "res", "obs-name"])
    assert {"proto-dispatch", "proto-frames", "proto-exact-read",
            "res-thread-join", "obs-name"} <= set(ids)
    # A family name selects its rules at check time too.
    assert check_project(Project.from_sources({}), ["proto"]) == []
    with pytest.raises(ValueError, match="families"):
        analysis.expand_rule_ids(["no-such-family"])


# -- locks -----------------------------------------------------------------

LOCK_GUARD_FIRE = f"{P}/serve/stateful.py"

LOCK_CLASS = '''
import threading

class Cache:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}

    def put(self, k, v):
        with self._lock:
            self._items[k] = v

    def rogue(self, k):
        self._items.pop(k, None)
'''


def test_lock_guard_fires_on_unlocked_mutation():
    found = findings_for({LOCK_GUARD_FIRE: LOCK_CLASS}, "lock-guard")
    assert len(found) == 1
    f = found[0]
    assert f.severity == "error"
    assert "_items" in f.message and "rogue" in f.message


def test_lock_guard_clean_when_mutation_is_locked():
    src = LOCK_CLASS.replace(
        "        self._items.pop(k, None)",
        "        with self._lock:\n            self._items.pop(k, None)")
    assert findings_for({LOCK_GUARD_FIRE: src}, "lock-guard") == []


def test_lock_guard_ignores_init_and_out_of_scope_dirs():
    # __init__ writes without the lock by design; and the same rogue
    # class outside coordinator/storage/serve/obs is not scanned.
    assert findings_for({f"{P}/core/stateful.py": LOCK_CLASS},
                        "lock-guard") == []


LOCK_ORDER_CYCLE = f'''
class A:
    def f(self):
        with self._a:
            with self._b:
                pass

    def g(self):
        with self._b:
            with self._a:
                pass
'''


def test_lock_order_reports_cycle():
    found = findings_for({f"{P}/storage/locks.py": LOCK_ORDER_CYCLE},
                         "lock-order")
    assert len(found) == 1
    assert "A._a" in found[0].message and "A._b" in found[0].message


def test_lock_order_clean_on_consistent_order():
    src = LOCK_ORDER_CYCLE.replace(
        "        with self._b:\n            with self._a:",
        "        with self._a:\n            with self._b:")
    assert findings_for({f"{P}/storage/locks.py": src}, "lock-order") == []


def test_lock_order_sees_through_same_class_calls():
    src = '''
class A:
    def outer(self):
        with self._a:
            self.inner()

    def inner(self):
        with self._b:
            pass

    def inverted(self):
        with self._b:
            with self._a:
                pass
'''
    found = findings_for({f"{P}/obs/locks.py": src}, "lock-order")
    assert len(found) == 1


LOCK_BLOCKING_CLASS = '''
import queue
import threading

class Pipe:
    def __init__(self):
        self._cond = threading.Condition()
        self._q = queue.Queue()

    def bad(self):
        with self._cond:
            item = self._q.get()
        return item

    def good(self):
        with self._cond:
            self._cond.wait(timeout=0.1)
        return self._q.get()
'''


def test_lock_held_blocking_fires_on_queue_get_under_lock():
    found = findings_for({f"{P}/worker/pipe.py": LOCK_BLOCKING_CLASS},
                         "lock-held-blocking")
    assert len(found) == 1
    f = found[0]
    assert f.severity == "error"
    assert ".get()" in f.message and "Pipe._cond" in f.message


def test_lock_held_blocking_covers_join_sem_event_and_client():
    src = '''
class W:
    def a(self):
        with self._lock:
            self.client.request_batch(4)

    def b(self):
        with self._lock:
            self._upload_thread.join()

    def c(self):
        with self._lock:
            self._dev_sem.acquire()

    def d(self):
        with self._lock:
            self._stop.wait(1.0)
'''
    found = findings_for({f"{P}/worker/w.py": src}, "lock-held-blocking")
    assert len(found) == 4


def test_lock_held_blocking_clean_cases():
    # Outside any lock; cond.wait on the HELD lock (the sanctioned
    # Condition protocol); dict .get under a lock; and the whole class
    # out of the scoped dirs.
    src = '''
class W:
    def a(self):
        item = self._q.get()
        with self._lock:
            self._seen = self._index.get(item)
        self._cond_other = 1

    def b(self):
        with self._cond:
            self._cond.wait(timeout=0.5)
            self._cond.notify_all()
'''
    assert findings_for({f"{P}/worker/w.py": src},
                        "lock-held-blocking") == []
    assert findings_for({f"{P}/core/pipe.py": LOCK_BLOCKING_CLASS},
                        "lock-held-blocking") == []


# -- locks: interprocedural (v2) -------------------------------------------

WRAPPED_BLOCKING = '''
import queue
import threading

class Stage:
    def __init__(self):
        self._lock = threading.Lock()
        self._q = queue.Queue()

    def _drain_one(self):
        return self._q.get()

    def bad(self):
        with self._lock:
            item = self._drain_one()
        return item
'''


def test_lock_held_blocking_sees_through_helper():
    # A one-level wrapper must not defeat the rule: bad() holds _lock
    # while calling _drain_one(), whose body blocks on the queue.
    found = findings_for({f"{P}/worker/stage.py": WRAPPED_BLOCKING},
                         "lock-held-blocking")
    assert len(found) == 1
    f = found[0]
    assert "reached via" in f.message and "_drain_one" in f.message
    assert "Stage._lock" in f.message


def test_lock_held_blocking_clean_when_helper_blocks_outside_lock():
    src = WRAPPED_BLOCKING.replace(
        "        with self._lock:\n            item = self._drain_one()",
        "        item = self._drain_one()\n        with self._lock:\n"
        "            self._seen = item")
    assert findings_for({f"{P}/worker/stage.py": src},
                        "lock-held-blocking") == []


CROSS_CLASS_CYCLE = '''
import threading

class A:
    def __init__(self, b: "B"):
        self.b = b
        self._la = threading.Lock()

    def f(self):
        with self._la:
            self.b.g()

    def grab(self):
        with self._la:
            pass

class B:
    def __init__(self, a: "A"):
        self.a = a
        self._lb = threading.Lock()

    def g(self):
        with self._lb:
            pass

    def h(self):
        with self._lb:
            self.a.grab()
'''


def test_lock_order_cycle_across_classes_via_call_graph():
    # A.f: holds A._la, calls B.g which takes B._lb; B.h holds B._lb and
    # calls A.grab which takes A._la.  Neither file nests two ``with``
    # blocks lexically — only the call graph sees the cycle.
    found = findings_for({f"{P}/storage/ab.py": CROSS_CLASS_CYCLE},
                         "lock-order")
    assert len(found) == 1
    assert "A._la" in found[0].message and "B._lb" in found[0].message


def test_lock_order_clean_when_cross_class_order_is_consistent():
    src = CROSS_CLASS_CYCLE.replace(
        "        with self._lb:\n            self.a.grab()",
        "        self.a.grab()\n        with self._lb:\n            pass")
    assert findings_for({f"{P}/storage/ab.py": src}, "lock-order") == []


# -- async -----------------------------------------------------------------

def test_async_blocking_fires_on_time_sleep_and_sync_framing():
    src = '''
import time
from distributedmandelbrot_tpu_torch.net import framing

class Handler:
    async def handle(self, sock):
        time.sleep(0.1)
        framing.send_u32(sock, 1)
'''
    found = findings_for({f"{P}/serve/h.py": src}, "async-blocking")
    assert len(found) == 2
    assert any("time.sleep" in f.message for f in found)
    assert any("send_u32" in f.message for f in found)


def test_async_blocking_clean_via_to_thread_and_async_framing():
    src = '''
import asyncio
from distributedmandelbrot_tpu_torch.net import framing

class Handler:
    async def handle(self, reader):
        await asyncio.sleep(0.1)
        n = await framing.read_u32(reader)
        payload = await asyncio.to_thread(self.store.load_payload, n, 0, 0)
        return payload
'''
    assert findings_for({f"{P}/serve/h.py": src}, "async-blocking") == []


def test_async_blocking_only_inside_async_defs():
    src = '''
import time

def sync_helper():
    time.sleep(0.1)
'''
    assert findings_for({f"{P}/serve/h.py": src}, "async-blocking") == []


def test_async_blocking_fires_on_sync_queue_in_coroutine():
    # The worker pipeline's stage queues are sync queue.Queue; feeding
    # one from a coroutine would park the whole event loop.  The
    # asyncio flavor is awaited (exempt), _nowait never blocks, and a
    # dict .get on a non-queue-named receiver is not a queue.
    src = '''
class G:
    async def pump(self):
        item = self._work_q.get()
        await self.handle(item)

    async def ok(self):
        item = await self._aio_queue.get()
        fast = self._work_q.get_nowait()
        meta = self.conf.get("k")
        return item, fast, meta

    async def handle(self, item):
        pass
'''
    found = findings_for({f"{P}/serve/pump.py": src}, "async-blocking")
    assert len(found) == 1
    assert "queue" in found[0].message and "await" in found[0].message


def test_async_unawaited_fires_on_bare_coroutine_call():
    src = '''
class G:
    async def go(self):
        pass

    async def run(self):
        self.go()
'''
    found = findings_for({f"{P}/serve/g.py": src}, "async-unawaited")
    assert len(found) == 1
    assert "self.go" in found[0].message


def test_async_unawaited_clean_when_awaited_or_scheduled():
    src = '''
import asyncio

class G:
    async def go(self):
        pass

    async def run(self):
        await self.go()
        task = asyncio.create_task(self.go())
        self._tasks.add(task)
'''
    assert findings_for({f"{P}/serve/g.py": src}, "async-unawaited") == []


def test_async_dropped_task_fires_and_kept_task_is_clean():
    fire = '''
import asyncio

async def work():
    pass

async def main():
    asyncio.create_task(work())
'''
    kept = '''
import asyncio

async def work():
    pass

async def main():
    task = asyncio.create_task(work())
    tasks.add(task)
    task.add_done_callback(tasks.discard)
'''
    assert len(findings_for({f"{P}/serve/t.py": fire},
                            "async-dropped-task")) == 1
    assert findings_for({f"{P}/serve/t.py": kept},
                        "async-dropped-task") == []


# -- wire ------------------------------------------------------------------

def test_wire_literal_fires_outside_canonical_modules():
    src = 'import struct\nHEADER = struct.Struct("<II")\n'
    found = findings_for({f"{P}/serve/proto_copy.py": src}, "wire-literal")
    assert len(found) == 1
    assert '"<II"' in found[0].message


def test_wire_literal_clean_in_canonical_modules():
    src = 'import struct\n_FMT = struct.Struct("<II")\n'
    for canonical in (f"{P}/net/protocol.py", f"{P}/codecs/custom.py"):
        assert findings_for({canonical: src}, "wire-literal") == []


def test_wire_size_fires_on_mismatched_constant():
    src = ('import struct\n'
           'QUERY = struct.Struct("<III")\n'
           'QUERY_WIRE_SIZE = 16\n')
    found = findings_for({f"{P}/net/protocol.py": src}, "wire-size")
    assert len(found) == 1
    assert "16" in found[0].message and "12" in found[0].message


def test_wire_size_fires_on_broken_query_tail_composition():
    src = ('import struct\n'
           'QUERY = struct.Struct("<III")\n'
           'QUERY_WIRE_SIZE = 12\n'
           'QUERY_TAIL = struct.Struct("<IQ")\n')
    found = findings_for({f"{P}/net/protocol.py": src}, "wire-size")
    assert len(found) == 1
    assert "byte-for-byte" in found[0].message


def test_wire_size_clean_on_consistent_constants():
    src = ('import struct\n'
           'QUERY = struct.Struct("<III")\n'
           'QUERY_WIRE_SIZE = 12\n'
           'QUERY_TAIL = struct.Struct("<II")\n'
           'QUERY_TAIL_WIRE_SIZE = 8\n')
    assert findings_for({f"{P}/net/protocol.py": src}, "wire-size") == []


def test_wire_parity_fires_when_speaker_retypes_format():
    src = ('import struct\n'
           '_QUERY = struct.Struct("<III")\n')
    found = findings_for({f"{P}/coordinator/dataserver.py": src},
                         "wire-parity")
    assert len(found) == 1
    assert "QUERY" in found[0].message


def test_wire_parity_clean_when_canonical_struct_used():
    src = ('from distributedmandelbrot_tpu_torch.net import protocol as proto\n'
           'SIZE = proto.QUERY.size\n')
    assert findings_for({f"{P}/coordinator/dataserver.py": src},
                        "wire-parity") == []
    # Modules absent from the project are skipped, not reported.
    assert findings_for({f"{P}/serve/other.py": "x = 1\n"},
                        "wire-parity") == []


# -- torch -----------------------------------------------------------------

TORCH_HEADER = ('import ctypes\n'
                'import numpy as np\n'
                'import torch\n')

LAUNCH_TEMPLATE = TORCH_HEADER + '''
def launch(lib, rows, julia, m, dev):
    row = np.asarray(rows, dtype=np.float32)
    out = torch.empty((8, 8), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dm_escape_tile(ctypes.c_void_p(out.data_ptr()),
                            ctypes.c_void_p(row.ctypes.data), int(julia),
                            int(m), float(np.float32(row[0])),
                            ctypes.c_void_p(stream))
    {read}
    return out
'''


@pytest.mark.parametrize("read", [
    "n = out.item()", "n = out.tolist()", "n = out.cpu()",
    "n = out.numpy()", 'n = out.to("cpu")', 'n = out.to(device="cpu")',
    "torch.cuda.synchronize()",
    "torch.cuda.current_stream(dev).synchronize()"])
def test_torch_host_sync_fires_on_each_device_read(read):
    src = LAUNCH_TEMPLATE.format(read=read)
    found = findings_for({f"{P}/ops/kern.py": src}, "torch-host-sync")
    assert len(found) == 1
    assert found[0].severity == "error"
    assert found[0].line == src.splitlines().index(f"    {read}") + 1
    assert "in launching function launch" in found[0].message


def test_torch_host_sync_clean_on_host_marshalling():
    """``int()``, ``float()`` and ``np.asarray`` marshal a wrapper's
    host arguments into the launch's C parameters: never a device read."""
    src = LAUNCH_TEMPLATE.format(read="n = int(m) + len(np.asarray([m]))")
    assert findings_for({f"{P}/ops/kern.py": src}, "torch-host-sync") == []


def test_torch_host_sync_clean_outside_launching_functions():
    src = TORCH_HEADER + '''
def host(lib, x):
    rc = lib.dm_error_string(3)
    blocks = lib.dm_persistent_blocks_per_sm(0, 1, 0, 0)
    tiles = lib.dm_mega_max_tiles()
    torch.cuda.synchronize()
    return x.cpu().numpy().tolist(), x.item(), rc, blocks, tiles
'''
    assert findings_for({f"{P}/ops/kern.py": src}, "torch-host-sync") == []
    from distributedmandelbrot_tpu_torch.analysis import rules_torch
    assert rules_torch.launching_functions(
        Project.from_sources({f"{P}/ops/kern.py": src})) == []


def test_torch_host_sync_fires_in_functions_nested_in_a_launcher():
    """K9's host loop: the launch and the census read sit in nested
    functions; both belong to the one launching function that holds
    them."""
    src = TORCH_HEADER + '''
def scan(lib, dev):
    def launch(k0, counts):
        lib.dm_perturb_scan(k0, counts)

    def segments(k0):
        counts = torch.zeros(4, dtype=torch.int32, device=dev)
        launch(k0, counts)
        return counts.tolist()

    return segments(0)
'''
    project = Project.from_sources({f"{P}/ops/scan.py": src})
    found = [f for f in check_project(project) if f.rule == "torch-host-sync"]
    assert len(found) == 1
    assert "in launching function scan" in found[0].message
    from distributedmandelbrot_tpu_torch.analysis import rules_torch
    launchers = rules_torch.launching_functions(project)
    assert [(x.name, x.entries) for x in launchers] == \
        [("scan", ("dm_perturb_scan",))]


def test_torch_host_sync_fires_in_methods():
    src = TORCH_HEADER + '''
class Backend:
    def dispatch(self, lib, out):
        lib.dm_escape_batch(out)
        return out.cpu()
'''
    found = findings_for({f"{P}/parallel/backend.py": src},
                         "torch-host-sync")
    assert len(found) == 1
    assert "in launching function Backend.dispatch" in found[0].message


def test_torch_rules_scope_is_ops_and_parallel():
    src = LAUNCH_TEMPLATE.format(read="n = out.item()")
    assert findings_for({f"{P}/worker/kern.py": src}, "torch-host-sync") == []
    assert len(findings_for({f"{P}/parallel/kern.py": src},
                            "torch-host-sync")) == 1


def test_torch_host_sync_suppressed_inline():
    src = LAUNCH_TEMPLATE.format(
        read="n = out.item()  # dmtpu: ignore[torch-host-sync]")
    report = run_check(Project.from_sources({f"{P}/ops/kern.py": src}),
                       ["torch"])
    assert report.clean
    assert [f.rule for f in report.suppressed] == ["torch-host-sync"]


def test_torch_dtype_mix_fires_on_half_literals_without_optin():
    src = LAUNCH_TEMPLATE.format(
        read="a = out.to(torch.bfloat16) + out.to(torch.float16)\n"
             "    b = out.to(torch.half) + out.half() + out.bfloat16()")
    found = findings_for({f"{P}/ops/mix.py": src}, "torch-dtype-mix")
    assert len(found) == 5
    assert all(f.severity == "warning" for f in found)


def test_torch_dtype_mix_clean_with_mixed_precision_import():
    src = (f"from {P}.ops.mixed_precision import scout_cast\n"
           + LAUNCH_TEMPLATE.format(read="a = out.to(torch.bfloat16)"))
    assert findings_for({f"{P}/ops/mix.py": src}, "torch-dtype-mix") == []


def test_torch_dtype_mix_clean_outside_launching_functions():
    src = TORCH_HEADER + '''
SCOUT = torch.bfloat16

def host(x):
    return x.to(torch.float16).half().bfloat16()
'''
    assert findings_for({f"{P}/ops/mix.py": src}, "torch-dtype-mix") == []


def test_torch_dtype_mix_ignores_wide_dtypes():
    """f64 needs no opt-in in eager PyTorch: ``jax-dtype`` has no
    counterpart."""
    src = LAUNCH_TEMPLATE.format(
        read='a = out.to(torch.float64) + out.to("float64")')
    project = Project.from_sources({f"{P}/ops/wide.py": src})
    assert [f for f in check_project(project)
            if f.rule.startswith("torch-")] == []


def test_torch_family_replaces_the_jax_family():
    rules = all_rules()
    assert not any(r.startswith("jax-") for r in rules)
    assert "jax" not in {r.family for r in rules.values()}
    assert sorted(analysis.expand_rule_ids(["torch"])) == \
        ["torch-dtype-mix", "torch-host-sync"]
    assert rules["torch-host-sync"].severity == "error"
    assert rules["torch-dtype-mix"].severity == "warning"


def test_torch_real_sites_are_suppressed_where_they_stand():
    """The port's two deliberate device reads beside a launch — K9's
    stagnation census and the MXU probe's wait — are inside the scope
    and carry ``# dmtpu: ignore[torch-host-sync]``; nothing else in the
    tree fires."""
    from distributedmandelbrot_tpu_torch.analysis import rules_torch
    project = Project.from_root(analysis.default_root())
    found = [f for f in rules_torch.check(project)]
    assert [(f.rule, f.path, f.message.rsplit("(", 1)[1]) for f in found] \
        == [("torch-host-sync", f"{P}/ops/cuda_perturb.py",
             "in launching function scan_state_with)"),
            ("torch-host-sync", f"{P}/ops/mxu_iteration.py",
             "in launching function probe_planes)")]
    assert ".tolist()" in found[0].message
    assert ".synchronize()" in found[1].message
    for f in found:
        assert project.file(f.path).is_suppressed(f.line, f.rule)
    assert run_check(project, ["torch"]).clean


def test_torch_scope_holds_every_kernel_wrapper_of_the_tree():
    from distributedmandelbrot_tpu_torch.analysis import rules_torch
    project = Project.from_root(analysis.default_root())
    entries = {e: x.name for x in rules_torch.launching_functions(project)
               for e in x.entries}
    assert entries == {
        "dm_escape_tile": "compute_tile_row_cuda",
        "dm_escape_mega": "launch_mega",
        "dm_escape_smooth": "compute_tile_smooth_cuda",
        "dm_escape_pack": "compute_tiles_packed_cuda",
        "dm_escape_batch": "compute_tiles_batch_cuda",
        "dm_escape_state": "escape_state_cuda",
        "dm_escape_resume": "escape_resume_cuda",
        "dm_perturb_scan": "scan_state_with",
        "dm_perturb_scan_smooth": "smooth_state_with",
        "dm_mxu_probe": "probe_planes",
        "dm_colormap_rgba8": "colormap_rgba8_cuda"}


# -- proto -----------------------------------------------------------------

PROTO_MOD = f"{P}/net/protocol.py"
PROTO_SRC = '''
import struct

PURPOSE_REQUEST = 0x00

QUERY = struct.Struct("<III")
QUERY_WIRE_SIZE = QUERY.size
QUERY_TAIL = struct.Struct("<II")
QUERY_TAIL_WIRE_SIZE = QUERY_TAIL.size
'''

PROTO_CLIENT = f"{P}/worker/client.py"
CLIENT_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (recv_u32, send_all,
                                                   send_byte)

class Client:
    def request(self, sock, a, b, c):
        send_byte(sock, proto.PURPOSE_REQUEST)
        send_all(sock, proto.QUERY.pack(a, b, c))
        return recv_u32(sock)
'''

PROTO_SERVER = f"{P}/coordinator/distributer.py"
SERVER_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (recv_byte, recv_exact,
                                                   send_u32)

class Server:
    def handle(self, sock):
        purpose = recv_byte(sock)
        if purpose == proto.PURPOSE_REQUEST:
            raw = recv_exact(sock, proto.QUERY.size)
            a, b, c = proto.QUERY.unpack(raw)
            send_u32(sock, a)
'''

PROTO_SOURCES = {PROTO_MOD: PROTO_SRC, PROTO_CLIENT: CLIENT_SRC,
                 PROTO_SERVER: SERVER_SRC}


def test_proto_clean_on_matched_exchange():
    for rule in ("proto-dispatch", "proto-frames", "proto-exact-read"):
        assert findings_for(PROTO_SOURCES, rule) == []


def test_proto_dispatch_fires_on_purpose_with_no_arm():
    # The deliberately introduced dispatch gap: the server stops testing
    # the purpose byte, so PURPOSE_REQUEST has no arm.
    gap = dict(PROTO_SOURCES)
    gap[PROTO_SERVER] = SERVER_SRC.replace(
        "        if purpose == proto.PURPOSE_REQUEST:\n", "        if True:\n")
    found = findings_for(gap, "proto-dispatch")
    assert len(found) == 1
    assert "PURPOSE_REQUEST has no server dispatch arm" in found[0].message
    assert found[0].path == PROTO_MOD


def test_proto_dispatch_fires_on_purpose_with_no_emitter():
    gap = dict(PROTO_SOURCES)
    gap[PROTO_CLIENT] = CLIENT_SRC.replace(
        "        send_byte(sock, proto.PURPOSE_REQUEST)\n", "")
    found = findings_for(gap, "proto-dispatch")
    assert len(found) == 1
    assert "no client emitter" in found[0].message


def test_proto_frames_fires_on_struct_disagreement():
    skewed = dict(PROTO_SOURCES)
    skewed[PROTO_SERVER] = SERVER_SRC.replace(
        "recv_exact(sock, proto.QUERY.size)",
        "recv_exact(sock, proto.QUERY_TAIL.size)").replace(
        "proto.QUERY.unpack(raw)", "proto.QUERY_TAIL.unpack(raw)")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "client sends [QUERY]" in found[0].message
    assert "server reads [QUERY_TAIL]" in found[0].message


def test_proto_frames_sees_through_helper_and_collapses_loops():
    # The emitter delegates the frame writes to a helper and the server
    # reads the struct in a loop — both must still compare clean.
    spliced = dict(PROTO_SOURCES)
    spliced[PROTO_CLIENT] = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (recv_u32, send_all,
                                                   send_byte)

class Client:
    def _emit_query(self, sock, a, b, c):
        send_all(sock, proto.QUERY.pack(a, b, c))

    def request(self, sock, a, b, c):
        send_byte(sock, proto.PURPOSE_REQUEST)
        self._emit_query(sock, a, b, c)
        return recv_u32(sock)
'''
    spliced[PROTO_SERVER] = SERVER_SRC.replace(
        "            raw = recv_exact(sock, proto.QUERY.size)\n",
        "            for _ in range(3):\n"
        "                raw = recv_exact(sock, proto.QUERY.size)\n")
    assert findings_for(spliced, "proto-frames") == []


def test_proto_exact_read_fires_on_raw_recv():
    raw = dict(PROTO_SOURCES)
    raw[PROTO_SERVER] = SERVER_SRC.replace(
        "recv_exact(sock, proto.QUERY.size)", "sock.recv(12)")
    found = findings_for(raw, "proto-exact-read")
    assert len(found) == 1
    assert "raw .recv()" in found[0].message


def test_proto_exact_read_fires_on_wrong_struct_size():
    wrong = dict(PROTO_SOURCES)
    wrong[PROTO_SERVER] = SERVER_SRC.replace(
        "recv_exact(sock, proto.QUERY.size)",
        "recv_exact(sock, proto.QUERY_TAIL.size)")
    found = findings_for(wrong, "proto-exact-read")
    assert len(found) == 1
    assert "sized as QUERY_TAIL, not QUERY" in found[0].message


def test_proto_silent_without_protocol_module():
    # Fixture projects with no net/protocol.py are out of scope.
    assert findings_for({PROTO_CLIENT: CLIENT_SRC}, "proto-dispatch") == []


# A stream-upgrade purpose (STREAM_FRAME_SYMBOLS): after the hello the
# connection multiplexes SESSION_FRAME-headed frames, so sequence parity
# covers only the ops before the first SESSION_FRAME on each side.
SESSION_PROTO_SRC = '''
import struct

PURPOSE_SESSION = 0x05

SESSION_HELLO = struct.Struct("<I")
SESSION_HELLO_WIRE_SIZE = SESSION_HELLO.size
SESSION_FRAME = struct.Struct("<BHI")
SESSION_FRAME_WIRE_SIZE = SESSION_FRAME.size
'''

SESSION_CLIENT_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (recv_byte, recv_exact,
                                                   send_all, send_byte)

class Session:
    def connect(self, sock, want):
        send_byte(sock, proto.PURPOSE_SESSION)
        send_all(sock, proto.SESSION_HELLO.pack(want))
        status = recv_byte(sock)
        raw = recv_exact(sock, proto.SESSION_HELLO_WIRE_SIZE)
        return status, proto.SESSION_HELLO.unpack(raw)[0]
'''

SESSION_SERVER_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (recv_byte, recv_exact,
                                                   send_all, send_byte)

class Server:
    def handle(self, sock):
        purpose = recv_byte(sock)
        if purpose == proto.PURPOSE_SESSION:
            raw = recv_exact(sock, proto.SESSION_HELLO.size)
            (want,) = proto.SESSION_HELLO.unpack(raw)
            send_byte(sock, 0x50)
            send_all(sock, proto.SESSION_HELLO.pack(want))
            while True:
                hdr = recv_exact(sock, proto.SESSION_FRAME_WIRE_SIZE)
                kind, seq, length = proto.SESSION_FRAME.unpack(hdr)
                body = recv_exact(sock, length)
                send_all(sock, proto.SESSION_FRAME.pack(kind, seq, 0))
'''

SESSION_SOURCES = {PROTO_MOD: SESSION_PROTO_SRC,
                   PROTO_CLIENT: SESSION_CLIENT_SRC,
                   PROTO_SERVER: SESSION_SERVER_SRC}


def test_proto_session_parity_checks_hello_prefix_only():
    # The server arm's frame loop (recv SESSION_FRAME, recv ?, send
    # SESSION_FRAME) never mirrors the one-shot hello emitter; the
    # stream truncation keeps parity scoped to the hello handshake.
    assert findings_for(SESSION_SOURCES, "proto-frames") == []
    assert findings_for(SESSION_SOURCES, "proto-dispatch") == []


def test_proto_session_fires_on_hello_prefix_mismatch():
    # A drift *inside* the hello prefix still fires: the server stops
    # writing the accept byte before its hello echo.
    skewed = dict(SESSION_SOURCES)
    skewed[PROTO_SERVER] = SESSION_SERVER_SRC.replace(
        "            send_byte(sock, 0x50)\n", "")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "client awaits [BYTE, SESSION_HELLO]" in found[0].message
    assert "server writes [SESSION_HELLO]" in found[0].message


def test_proto_session_dispatch_fires_without_emitter():
    gap = dict(SESSION_SOURCES)
    gap[PROTO_CLIENT] = SESSION_CLIENT_SRC.replace(
        "        send_byte(sock, proto.PURPOSE_SESSION)\n", "")
    found = findings_for(gap, "proto-dispatch")
    assert len(found) == 1
    assert "PURPOSE_SESSION has no client emitter" in found[0].message


# The magic-dispatched rendered-tile exchange (QUERY_EXCHANGES entry
# "render_query"): no purpose byte — the gateway sniffs a magic u32 —
# so client emitter and server handler are paired by qualname.
RENDER_PROTO_SRC = PROTO_SRC + '''
RENDER_QUERY_TAIL = struct.Struct("<IIIBB")
RENDER_QUERY_TAIL_WIRE_SIZE = RENDER_QUERY_TAIL.size
'''

RENDER_CLIENT = f"{P}/viewer/client.py"
RENDER_CLIENT_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (recv_byte, recv_exact,
                                                   recv_u32, send_all)

class DataClient:
    def _render_exchange(self, sock, level, i, j, colormap_id):
        send_all(sock, proto.RENDER_QUERY_TAIL.pack(level, i, j,
                                                    colormap_id, 0))
        status = recv_byte(sock)
        length = recv_u32(sock)
        return recv_exact(sock, length), status
'''

RENDER_SERVER = f"{P}/serve/gateway.py"
RENDER_SERVER_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (read_exact, write_byte,
                                                   write_u32)

class TileGateway:
    async def _serve_render(self, reader, writer):
        raw = await read_exact(reader, proto.RENDER_QUERY_TAIL.size)
        level, i, j, colormap_id, flags = proto.RENDER_QUERY_TAIL.unpack(raw)
        body = self._render(level, i, j, colormap_id)
        write_byte(writer, 0x10)
        write_u32(writer, len(body))
        writer.write(body)
'''

RENDER_SOURCES = {PROTO_MOD: RENDER_PROTO_SRC,
                  RENDER_CLIENT: RENDER_CLIENT_SRC,
                  RENDER_SERVER: RENDER_SERVER_SRC}


def test_proto_render_exchange_clean_when_sequences_match():
    for rule in ("proto-frames", "proto-exact-read"):
        assert findings_for(RENDER_SOURCES, rule) == []


def test_proto_render_exchange_fires_when_client_sends_wrong_struct():
    # Version-skew drift: a client still speaking the raw-tile QUERY at
    # a render endpoint must be caught as a sequence mismatch.
    skewed = dict(RENDER_SOURCES)
    skewed[RENDER_CLIENT] = RENDER_CLIENT_SRC.replace(
        "proto.RENDER_QUERY_TAIL.pack(level, i, j,\n"
        "                                                    colormap_id, 0)",
        "proto.QUERY.pack(level, i, j)")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "render_query" in found[0].message
    assert "client sends [QUERY]" in found[0].message
    assert "server reads [RENDER_QUERY_TAIL]" in found[0].message
    assert found[0].path == RENDER_SERVER


def test_proto_render_exchange_fires_when_server_drops_status_byte():
    skewed = dict(RENDER_SOURCES)
    skewed[RENDER_SERVER] = RENDER_SERVER_SRC.replace(
        "        write_byte(writer, 0x10)\n", "")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "client awaits [BYTE, U32, ?]" in found[0].message
    assert "server writes [U32, ?]" in found[0].message


def test_proto_render_exchange_skipped_when_one_side_absent():
    # Exchange parity only applies when both qualnames exist — fixture
    # projects (and partial source sets) must stay silent.
    one_sided = {PROTO_MOD: RENDER_PROTO_SRC,
                 RENDER_CLIENT: RENDER_CLIENT_SRC}
    assert findings_for(one_sided, "proto-frames") == []


# The session-scoped query (QUERY_EXCHANGES entry "session_query"):
# magic sniffed like the render exchange, but the reply leads with a
# fixed SESSION_REPLY header (new session id + granted caps) before the
# standard status byte — the parity check must see that header on both
# sides.
SQUERY_PROTO_SRC = PROTO_SRC + '''
SESSION_QUERY_TAIL = struct.Struct("<QIIIBB")
SESSION_QUERY_TAIL_WIRE_SIZE = SESSION_QUERY_TAIL.size
SESSION_REPLY = struct.Struct("<QB")
SESSION_REPLY_WIRE_SIZE = SESSION_REPLY.size
'''

SQUERY_CLIENT = f"{P}/viewer/client.py"
SQUERY_CLIENT_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (recv_byte, recv_exact,
                                                   recv_u32, send_all)

class DataClient:
    def _session_exchange(self, sock, session_id, level, i, j,
                          colormap_id, flags):
        send_all(sock, proto.SESSION_QUERY_TAIL.pack(
            session_id, level, i, j, colormap_id, flags))
        sid, caps = proto.SESSION_REPLY.unpack(
            recv_exact(sock, proto.SESSION_REPLY_WIRE_SIZE))
        status = recv_byte(sock)
        length = recv_u32(sock)
        return recv_exact(sock, length), status
'''

SQUERY_SERVER = f"{P}/serve/gateway.py"
SQUERY_SERVER_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (read_exact, write_byte,
                                                   write_u32)

class TileGateway:
    async def _serve_session(self, reader, writer):
        raw = await read_exact(reader, proto.SESSION_QUERY_TAIL.size)
        (session_id, level, i, j,
         colormap_id, flags) = proto.SESSION_QUERY_TAIL.unpack(raw)
        sid, caps, body = self._resolve(session_id, level, i, j,
                                        colormap_id, flags)
        writer.write(proto.SESSION_REPLY.pack(sid, caps))
        write_byte(writer, 0x10)
        write_u32(writer, len(body))
        writer.write(body)
'''

SQUERY_SOURCES = {PROTO_MOD: SQUERY_PROTO_SRC,
                  SQUERY_CLIENT: SQUERY_CLIENT_SRC,
                  SQUERY_SERVER: SQUERY_SERVER_SRC}


def test_proto_session_query_clean_when_sequences_match():
    for rule in ("proto-frames", "proto-exact-read"):
        assert findings_for(SQUERY_SOURCES, rule) == []


def test_proto_session_query_fires_when_client_sends_legacy_tail():
    # Version-skew drift: a legacy client speaking the raw 12-byte QUERY
    # at the session magic must be caught as a sequence mismatch.
    skewed = dict(SQUERY_SOURCES)
    skewed[SQUERY_CLIENT] = SQUERY_CLIENT_SRC.replace(
        "proto.SESSION_QUERY_TAIL.pack(\n"
        "            session_id, level, i, j, colormap_id, flags)",
        "proto.QUERY.pack(level, i, j)")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "session_query" in found[0].message
    assert "client sends [QUERY]" in found[0].message
    assert "server reads [SESSION_QUERY_TAIL]" in found[0].message


def test_proto_session_query_fires_when_server_drops_reply_header():
    # The SESSION_REPLY header precedes the status byte; a server that
    # jumps straight to the status desynchronizes every client read.
    skewed = dict(SQUERY_SOURCES)
    skewed[SQUERY_SERVER] = SQUERY_SERVER_SRC.replace(
        "        writer.write(proto.SESSION_REPLY.pack(sid, caps))\n", "")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "client awaits [SESSION_REPLY, BYTE, U32, ?]" in found[0].message
    assert "server writes [BYTE, U32, ?]" in found[0].message


def test_proto_session_query_skipped_when_one_side_absent():
    one_sided = {PROTO_MOD: SQUERY_PROTO_SRC,
                 SQUERY_SERVER: SQUERY_SERVER_SRC}
    assert findings_for(one_sided, "proto-frames") == []


# The batched lease exchange (SESSION_EXCHANGES entry "lease_reqn"):
# an exchange INSIDE the multiplexed session stream, so ops carrying
# the frame-header symbol are filtered from both sides and the payload
# sequences (REQN out, GRANTN + grant groups back) must mirror.
GRANTN_PROTO_SRC = '''
import struct

SESSION_FRAME = struct.Struct("<BHI")
SESSION_FRAME_WIRE_SIZE = SESSION_FRAME.size
LEASE_REQN = struct.Struct("<II")
LEASE_REQN_WIRE_SIZE = LEASE_REQN.size
LEASE_GRANTN = struct.Struct("<II")
LEASE_GRANTN_WIRE_SIZE = LEASE_GRANTN.size
GRANT_WANT = struct.Struct("<I")
GRANT_WANT_WIRE_SIZE = GRANT_WANT.size
'''

GRANTN_CLIENT_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import (recv_exact, recv_u32,
                                                   send_all)

class DistributerSession:
    def _request_batchn(self, sock, max_count, width):
        send_all(sock, proto.SESSION_FRAME.pack(0x06, 0,
                                                proto.LEASE_REQN_WIRE_SIZE))
        send_all(sock, proto.LEASE_REQN.pack(max_count, width))
        hdr = recv_exact(sock, proto.SESSION_FRAME_WIRE_SIZE)
        raw = recv_exact(sock, proto.LEASE_GRANTN_WIRE_SIZE)
        n_batches, n_tiles = proto.LEASE_GRANTN.unpack(raw)
        for _ in range(n_batches):
            n = recv_u32(sock)
        return n_tiles
'''

GRANTN_SERVER_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import read_exact, write_u32

class Distributer:
    async def _session_lease_reqn(self, reader, writer, seq):
        raw = await read_exact(reader, proto.LEASE_REQN_WIRE_SIZE)
        count, width = proto.LEASE_REQN.unpack(raw)
        writer.write(proto.SESSION_FRAME.pack(0x07, seq,
                                              proto.LEASE_GRANTN_WIRE_SIZE))
        writer.write(proto.LEASE_GRANTN.pack(1, count))
        write_u32(writer, count)
'''

GRANTN_SOURCES = {PROTO_MOD: GRANTN_PROTO_SRC,
                  PROTO_CLIENT: GRANTN_CLIENT_SRC,
                  PROTO_SERVER: GRANTN_SERVER_SRC}


def test_proto_grantn_exchange_clean_when_sequences_match():
    for rule in ("proto-frames", "proto-exact-read"):
        assert findings_for(GRANTN_SOURCES, rule) == []


def test_proto_grantn_exchange_fires_when_server_reverts_to_flat_grants():
    # Version-skew drift: a coordinator answering a REQN with the legacy
    # flat grant list (no GRANTN group header) must be caught.
    skewed = dict(GRANTN_SOURCES)
    skewed[PROTO_SERVER] = GRANTN_SERVER_SRC.replace(
        "        writer.write(proto.LEASE_GRANTN.pack(1, count))\n", "")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "lease_reqn" in found[0].message
    assert "client awaits [LEASE_GRANTN, U32]" in found[0].message
    assert "server writes [U32]" in found[0].message


def test_proto_grantn_exchange_fires_when_client_sends_wrong_struct():
    # A client still speaking the legacy flat lease want (a bare u32
    # struct, 4 bytes vs REQN's 8) at the batched endpoint.
    skewed = dict(GRANTN_SOURCES)
    skewed[PROTO_CLIENT] = GRANTN_CLIENT_SRC.replace(
        "proto.LEASE_REQN.pack(max_count, width)",
        "proto.GRANT_WANT.pack(max_count)")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "lease_reqn" in found[0].message
    assert "client sends [GRANT_WANT]" in found[0].message
    assert "server reads [LEASE_REQN]" in found[0].message


def test_proto_grantn_exchange_skipped_when_one_side_absent():
    one_sided = {PROTO_MOD: GRANTN_PROTO_SRC,
                 PROTO_CLIENT: GRANTN_CLIENT_SRC}
    assert findings_for(one_sided, "proto-frames") == []


# The ring exchange (SESSION_EXCHANGES entry "ring_req"): the sharded
# control plane's skew probe, another exchange inside the session
# stream — RING_REQ (the client's ring version) out, RING_INFO (the
# authoritative version + slice identity) back.
RING_PROTO_SRC = '''
import struct

SESSION_FRAME = struct.Struct("<BHI")
SESSION_FRAME_WIRE_SIZE = SESSION_FRAME.size
RING_REQ = struct.Struct("<I")
RING_REQ_WIRE_SIZE = RING_REQ.size
RING_INFO = struct.Struct("<III")
RING_INFO_WIRE_SIZE = RING_INFO.size
REDIRECT = struct.Struct("<II")
REDIRECT_WIRE_SIZE = REDIRECT.size
'''

RING_CLIENT_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import recv_exact, send_all

class DistributerSession:
    def ring_info(self, sock, client_version):
        send_all(sock, proto.SESSION_FRAME.pack(0x08, 0,
                                                proto.RING_REQ_WIRE_SIZE))
        send_all(sock, proto.RING_REQ.pack(client_version))
        hdr = recv_exact(sock, proto.SESSION_FRAME_WIRE_SIZE)
        raw = recv_exact(sock, proto.RING_INFO_WIRE_SIZE)
        return proto.RING_INFO.unpack(raw)
'''

RING_SERVER_SRC = '''
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.net.framing import read_exact

class Distributer:
    async def _session_ring_req(self, reader, writer, seq):
        raw = await read_exact(reader, proto.RING_REQ_WIRE_SIZE)
        (client_version,) = proto.RING_REQ.unpack(raw)
        writer.write(proto.SESSION_FRAME.pack(0x09, seq,
                                              proto.RING_INFO_WIRE_SIZE))
        writer.write(proto.RING_INFO.pack(1, 0, 1))
'''

RING_SOURCES = {PROTO_MOD: RING_PROTO_SRC,
                PROTO_CLIENT: RING_CLIENT_SRC,
                PROTO_SERVER: RING_SERVER_SRC}


def test_proto_ring_exchange_clean_when_sequences_match():
    for rule in ("proto-frames", "proto-exact-read"):
        assert findings_for(RING_SOURCES, rule) == []


def test_proto_ring_exchange_fires_when_server_answers_redirect():
    # Version-skew drift: a coordinator answering the skew probe with a
    # REDIRECT payload (8 bytes) where the client awaits RING_INFO (12)
    # must be caught as a sequence mismatch.
    skewed = dict(RING_SOURCES)
    skewed[PROTO_SERVER] = RING_SERVER_SRC.replace(
        "proto.RING_INFO.pack(1, 0, 1)", "proto.REDIRECT.pack(0, 1)")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "ring_req" in found[0].message
    assert "client awaits [RING_INFO]" in found[0].message
    assert "server writes [REDIRECT]" in found[0].message


def test_proto_ring_exchange_fires_when_client_sends_wrong_struct():
    # A client pushing a REDIRECT body (8 bytes) into the 4-byte
    # RING_REQ slot — the misroute-chasing code path leaking into the
    # skew probe.
    skewed = dict(RING_SOURCES)
    skewed[PROTO_CLIENT] = RING_CLIENT_SRC.replace(
        "proto.RING_REQ.pack(client_version)",
        "proto.REDIRECT.pack(client_version, 0)")
    found = findings_for(skewed, "proto-frames")
    assert len(found) == 1
    assert "ring_req" in found[0].message
    assert "client sends [REDIRECT]" in found[0].message
    assert "server reads [RING_REQ]" in found[0].message


def test_proto_ring_exchange_skipped_when_one_side_absent():
    one_sided = {PROTO_MOD: RING_PROTO_SRC,
                 PROTO_SERVER: RING_SERVER_SRC}
    assert findings_for(one_sided, "proto-frames") == []


# -- res -------------------------------------------------------------------

def test_res_thread_join_fires_on_unjoined_handleless_thread():
    src = '''
import threading

class R:
    def start(self):
        t = threading.Thread(target=self._run)
        t.start()
        threading.Thread(target=self._pump).start()
'''
    found = findings_for({f"{P}/worker/r.py": src}, "res-thread-join")
    assert len(found) == 2
    assert any("no handle" in f.message for f in found)


def test_res_thread_join_clean_on_daemon_join_and_list_join():
    src = '''
import threading

class R:
    def start(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        self._workers = [threading.Thread(target=self._pump)
                         for _ in range(4)]

    def stop(self):
        for t in self._workers:
            t.join()
'''
    assert findings_for({f"{P}/worker/r.py": src}, "res-thread-join") == []


def test_res_socket_close_fires_and_clean_variants():
    fire = '''
import socket

class C:
    def connect(self, addr):
        sock = socket.create_connection(addr)
        sock.sendall(b"x")
'''
    clean = '''
import socket

class C:
    def connect(self, addr):
        self.sock = socket.create_connection(addr)

    def probe(self, addr):
        sock = socket.create_connection(addr)
        try:
            sock.sendall(b"x")
        finally:
            sock.close()
'''
    found = findings_for({f"{P}/net/c.py": fire}, "res-socket-close")
    assert len(found) == 1
    assert "never closed" in found[0].message
    assert findings_for({f"{P}/net/c.py": clean}, "res-socket-close") == []


def test_res_queue_unbounded_fires_only_without_maxsize():
    src = '''
import queue

class Q:
    def __init__(self):
        self._work = queue.Queue()
        self._done = queue.Queue(maxsize=8)
'''
    found = findings_for({f"{P}/worker/q.py": src}, "res-queue-unbounded")
    assert len(found) == 1
    assert found[0].severity == "warning"


def test_res_shutdown_fires_without_stop_hook():
    src = '''
from concurrent.futures import ThreadPoolExecutor

class S:
    def __init__(self):
        self.pool = ThreadPoolExecutor(max_workers=2)
'''
    found = findings_for({f"{P}/coordinator/s.py": src}, "res-shutdown")
    assert len(found) == 1
    assert "shutdown" in found[0].message
    healed = src + '''
    def close(self):
        self.pool.shutdown(wait=False)
'''
    assert findings_for({f"{P}/coordinator/s.py": healed},
                        "res-shutdown") == []


def test_res_rules_skip_out_of_scope_dirs():
    src = '''
import queue

class Q:
    def __init__(self):
        self._work = queue.Queue()
'''
    assert findings_for({f"{P}/core/q.py": src}, "res-queue-unbounded") == []


# -- obs-name --------------------------------------------------------------

NAMES_MOD = f"{P}/obs/names.py"
NAMES_SRC = '''
TILES_DONE = "tiles_done"

LEGACY_ALIASES: dict[str, str] = {TILES_DONE: "tiles_complete"}
'''


def test_obs_name_fires_on_unregistered_literal():
    src = '''
class W:
    def f(self):
        self.counters.inc("tiles_done")
        self.counters.inc("tiles_complete")
        self.counters.inc("tils_done")
        self.conf.get("not_a_metric")
'''
    found = findings_for({NAMES_MOD: NAMES_SRC, f"{P}/worker/w.py": src},
                         "obs-name")
    assert len(found) == 1
    assert "'tils_done'" in found[0].message
    # Without a names module there is no arbiter — stay silent.
    assert findings_for({f"{P}/worker/w.py": src}, "obs-name") == []


def test_obs_name_covers_span_recorder_sites():
    src = '''
class W:
    def f(self):
        self.spans.record("not_registered", 0, 1.0, 2.0)
'''
    found = findings_for({NAMES_MOD: NAMES_SRC, f"{P}/worker/w.py": src},
                         "obs-name")
    assert len(found) == 1


# -- obs-dead --------------------------------------------------------------

DEAD_NAMES_SRC = '''
TILES_DONE = "tiles_done"
GHOST_DEPTH = "ghost_depth"

LEGACY_ALIASES: dict[str, str] = {TILES_DONE: "tiles_complete"}
'''


def test_obs_dead_fires_on_uninstrumented_registration():
    src = '''
class W:
    def f(self):
        self.counters.inc("tiles_done")
'''
    found = findings_for({NAMES_MOD: DEAD_NAMES_SRC,
                          f"{P}/worker/w.py": src}, "obs-dead")
    assert len(found) == 1
    assert "GHOST_DEPTH" in found[0].message
    assert found[0].path == NAMES_MOD  # anchored at the registration


def test_obs_dead_clean_when_referenced_by_attribute_or_literal():
    src = f'''
from {P}.obs import names as obs_names


class W:
    def f(self):
        self.counters.inc("tiles_done")
        self.gauges.set(obs_names.GHOST_DEPTH, 2)
'''
    assert findings_for({NAMES_MOD: DEAD_NAMES_SRC,
                         f"{P}/worker/w.py": src}, "obs-dead") == []


# -- obs-event -------------------------------------------------------------

EVENTS_MOD = f"{P}/obs/events.py"
EVENTS_SRC = '''
SCHED_GRANT = "sched.grant"
CKPT_DONE = "ckpt.done"
'''


def test_obs_event_fires_on_unregistered_literal():
    src = '''
from distributedmandelbrot_tpu_torch.obs import flight


def f(self):
    flight.note("sched.grant")
    flight.note("sched.grnat")
    self.notebook.note("not.an.event")
'''
    found = findings_for({EVENTS_MOD: EVENTS_SRC,
                          f"{P}/coordinator/s.py": src}, "obs-event")
    # one unregistered emit + CKPT_DONE registered-but-never-emitted
    assert len(found) == 2
    assert any("'sched.grnat'" in f.message for f in found)
    # Without an events module there is no arbiter — stay silent.
    assert findings_for({f"{P}/coordinator/s.py": src}, "obs-event") == []


def test_obs_event_reverse_audit_accepts_attr_and_import_refs():
    src = f'''
from {P}.obs import events as obs_events
from {P}.obs import flight


def f():
    flight.note(obs_events.SCHED_GRANT)
    flight.note("ckpt.done")
'''
    assert findings_for({EVENTS_MOD: EVENTS_SRC,
                         f"{P}/coordinator/s.py": src}, "obs-event") == []


def test_obs_event_reverse_audit_fires_on_ghost_event():
    src = '''
from distributedmandelbrot_tpu_torch.obs import flight


def f():
    flight.note("sched.grant")
'''
    found = findings_for({EVENTS_MOD: EVENTS_SRC,
                          f"{P}/coordinator/s.py": src}, "obs-event")
    assert len(found) == 1
    assert "CKPT_DONE" in found[0].message
    assert found[0].path == EVENTS_MOD  # anchored at the registration


# -- fsm: protocol state machines ------------------------------------------

FSM_CLIENT_REL = f"{P}/viewer/client.py"
FSM_SERVER_REL = f"{P}/coordinator/dataserver.py"

FSM_QUERY_CLIENT = f'''
from {P}.net import framing
from {P}.net import protocol as proto


class DataClient:
    def _fetch_once(self, sock, level, ir, ii):
        framing.send_all(sock, proto.QUERY.pack(level, ir, ii))
        status = framing.recv_byte(sock)
        if status == proto.QUERY_REJECT:
            return None
        if status != proto.QUERY_ACCEPT:
            raise framing.ProtocolError("bad status")
        return b"tile"
'''

FSM_QUERY_SERVER = f'''
from {P}.net import framing
from {P}.net import protocol as proto


class DataServer:
    def _handle_connection(self, conn):
        level, ir, ii = proto.QUERY.unpack(
            framing.recv_exact(conn, proto.QUERY.size))
        if self._have(level, ir, ii):
            framing.send_byte(conn, proto.QUERY_ACCEPT)
        else:
            framing.send_byte(conn, proto.QUERY_REJECT)

    def _have(self, level, ir, ii):
        return True
'''


def test_fsm_dual_fires_on_send_without_receive_arm():
    # The client piggybacks a RENDER_QUERY_TAIL the server never reads.
    client = FSM_QUERY_CLIENT.replace(
        "        status = framing.recv_byte(sock)",
        "        framing.send_all(sock, proto.RENDER_QUERY_TAIL.pack(0, 0))\n"
        "        status = framing.recv_byte(sock)")
    found = findings_for({FSM_CLIENT_REL: client,
                          FSM_SERVER_REL: FSM_QUERY_SERVER}, "fsm-dual")
    assert found
    assert "RENDER_QUERY_TAIL" in found[0].message


def test_fsm_dual_clean_on_matched_pair():
    assert findings_for({FSM_CLIENT_REL: FSM_QUERY_CLIENT,
                         FSM_SERVER_REL: FSM_QUERY_SERVER}, "fsm-dual") == []


def test_fsm_dead_arm_fires_on_branch_no_config_reaches():
    # Server can only ever accept, so the client's REJECT arm is dead.
    server = FSM_QUERY_SERVER.replace(
        """        if self._have(level, ir, ii):
            framing.send_byte(conn, proto.QUERY_ACCEPT)
        else:
            framing.send_byte(conn, proto.QUERY_REJECT)""",
        "        framing.send_byte(conn, proto.QUERY_ACCEPT)")
    found = findings_for({FSM_CLIENT_REL: FSM_QUERY_CLIENT,
                          FSM_SERVER_REL: server}, "fsm-dead-arm")
    assert len(found) == 1
    assert "QUERY_REJECT" in found[0].message
    assert found[0].path == FSM_CLIENT_REL


def test_fsm_dead_arm_clean_when_both_branches_reachable():
    assert findings_for({FSM_CLIENT_REL: FSM_QUERY_CLIENT,
                         FSM_SERVER_REL: FSM_QUERY_SERVER},
                        "fsm-dead-arm") == []


FSM_SESSION_CLIENT_REL = f"{P}/worker/client.py"
FSM_SESSION_SERVER_REL = f"{P}/coordinator/distributer.py"

# The gate test on the send is what separates fire from no-fire below.
FSM_SESSION_CLIENT_GUARDED = f'''
from {P}.net import framing
from {P}.net import protocol as proto


class DistributerSession:
    def connect(self):
        framing.send_byte(self._sock, proto.PURPOSE_SESSION)
        return True

    def upload(self, seq):
        framing.send_all(
            self._sock,
            proto.SESSION_FRAME.pack(proto.FRAME_UPLOAD, seq, 0))

    def send_spans(self, seq):
        if self.flags & proto.SESSION_FLAG_RLE:
            framing.send_all(
                self._sock,
                proto.SESSION_FRAME.pack(proto.FRAME_SPANS, seq, 0))
'''

FSM_SESSION_SERVER_GATED = f'''
from {P}.net import framing
from {P}.net import protocol as proto


class Distributer:
    async def _handle_session(self, reader, writer):
        while True:
            try:
                frame_type, seq, length = proto.SESSION_FRAME.unpack(
                    await framing.read_exact(
                        reader, proto.SESSION_FRAME.size))
            except ConnectionError:
                return
            if frame_type == proto.FRAME_UPLOAD:
                continue
            if self.caps & proto.SESSION_FLAG_RLE:
                if frame_type == proto.FRAME_SPANS:
                    continue
            raise framing.ProtocolError("unexpected frame")
'''


def test_fsm_cap_gate_fires_on_unguarded_send():
    client = FSM_SESSION_CLIENT_GUARDED.replace(
        """        if self.flags & proto.SESSION_FLAG_RLE:
            framing.send_all(
                self._sock,
                proto.SESSION_FRAME.pack(proto.FRAME_SPANS, seq, 0))""",
        """        framing.send_all(
            self._sock,
            proto.SESSION_FRAME.pack(proto.FRAME_SPANS, seq, 0))""")
    found = findings_for({FSM_SESSION_CLIENT_REL: client,
                          FSM_SESSION_SERVER_REL: FSM_SESSION_SERVER_GATED},
                         "fsm-cap-gate")
    assert found
    assert "RLE" in found[0].message


def test_fsm_cap_gate_clean_when_send_guarded_by_same_cap():
    sources = {FSM_SESSION_CLIENT_REL: FSM_SESSION_CLIENT_GUARDED,
               FSM_SESSION_SERVER_REL: FSM_SESSION_SERVER_GATED}
    assert findings_for(sources, "fsm-cap-gate") == []


def test_fsm_deadlock_fires_on_desynced_fixture():
    # One send, two reads: the product wedges with both sides waiting.
    server = FSM_QUERY_SERVER.replace(
        "        level, ir, ii = proto.QUERY.unpack(\n"
        "            framing.recv_exact(conn, proto.QUERY.size))",
        "        level, ir, ii = proto.QUERY.unpack(\n"
        "            framing.recv_exact(conn, proto.QUERY.size))\n"
        "        level, ir, ii = proto.QUERY.unpack(\n"
        "            framing.recv_exact(conn, proto.QUERY.size))")
    found = findings_for({FSM_CLIENT_REL: FSM_QUERY_CLIENT,
                          FSM_SERVER_REL: server}, "fsm-deadlock")
    assert found
    assert "client@" in found[0].message and "server@" in found[0].message


# -- engine: suppressions, baseline, reporters -----------------------------

def test_inline_suppression_same_line_and_line_above():
    same_line = LOCK_CLASS.replace(
        "        self._items.pop(k, None)",
        "        self._items.pop(k, None)  # dmtpu: ignore[lock-guard] ok")
    line_above = LOCK_CLASS.replace(
        "        self._items.pop(k, None)",
        "        # dmtpu: ignore[lock-guard] single-threaded teardown\n"
        "        self._items.pop(k, None)")
    for src in (same_line, line_above):
        report = run_check(Project.from_sources({LOCK_GUARD_FIRE: src}))
        assert report.clean
        assert [f.rule for f in report.suppressed] == ["lock-guard"]


def test_suppression_wildcard_and_wrong_rule():
    wildcard = LOCK_CLASS.replace(
        "        self._items.pop(k, None)",
        "        self._items.pop(k, None)  # dmtpu: ignore[*]")
    wrong = LOCK_CLASS.replace(
        "        self._items.pop(k, None)",
        "        self._items.pop(k, None)  # dmtpu: ignore[wire-literal]")
    assert run_check(Project.from_sources({LOCK_GUARD_FIRE: wildcard})).clean
    report = run_check(Project.from_sources({LOCK_GUARD_FIRE: wrong}))
    assert [f.rule for f in report.findings] == ["lock-guard"]


def test_baseline_grandfathers_and_reports_stale(tmp_path):
    project = Project.from_sources({LOCK_GUARD_FIRE: LOCK_CLASS})
    finding = check_project(project, ["lock-guard"])[0]
    path = tmp_path / "baseline.json"
    analysis.save_baseline(path, [finding])
    baseline = analysis.load_baseline(path)
    report = run_check(project, baseline=baseline)
    assert report.clean
    assert [f.fingerprint() for f in report.baselined] == sorted(baseline)
    # An entry matching nothing is stale and must be reported.
    report = run_check(Project.from_sources({}), baseline={"gone::x.py::y"})
    assert report.stale_baseline == ["gone::x.py::y"]


def test_baseline_survives_line_drift():
    project = Project.from_sources(
        {LOCK_GUARD_FIRE: "# a new leading comment\n" + LOCK_CLASS})
    shifted = check_project(project, ["lock-guard"])[0]
    original = check_project(
        Project.from_sources({LOCK_GUARD_FIRE: LOCK_CLASS}),
        ["lock-guard"])[0]
    assert shifted.line != original.line
    assert shifted.fingerprint() == original.fingerprint()


def test_parse_error_reported_as_finding():
    report = run_check(Project.from_sources(
        {f"{P}/serve/broken.py": "def f(:\n"}))
    assert [f.rule for f in report.findings] == ["parse-error"]
    assert report.findings[0].severity == "error"


def test_json_report_schema():
    report = run_check(Project.from_sources({LOCK_GUARD_FIRE: LOCK_CLASS}))
    doc = json.loads(analysis.render_json(report))
    assert doc["version"] == 1
    assert set(doc["counts"]) == {"error", "warning", "total",
                                  "suppressed", "baselined"}
    assert doc["counts"]["total"] == len(doc["findings"]) == 1
    assert set(doc["findings"][0]) == {"rule", "severity", "path",
                                       "line", "message"}
    assert doc["stale_baseline"] == []


def test_text_report_format_is_clickable():
    report = run_check(Project.from_sources({LOCK_GUARD_FIRE: LOCK_CLASS}))
    line = analysis.render_text(report).splitlines()[0]
    assert line.startswith(f"{LOCK_GUARD_FIRE}:")
    assert ": error: [lock-guard]" in line


# -- CLI: --update-baseline round trip -------------------------------------

def test_cli_update_baseline_round_trip(tmp_path, capsys):
    from distributedmandelbrot_tpu_torch.cli import main
    pkg = tmp_path / P / "serve"
    pkg.mkdir(parents=True)
    (pkg / "stateful.py").write_text(LOCK_CLASS)
    baseline = tmp_path / "baseline.json"

    # Dirty tree exits 1...
    assert main(["check", "--root", str(tmp_path),
                 "--baseline", str(baseline)]) == 1
    # ...--update-baseline grandfathers it...
    assert main(["check", "--root", str(tmp_path),
                 "--baseline", str(baseline), "--update-baseline"]) == 0
    # ...after which the same tree is clean and the entry is live (not
    # stale).
    assert main(["check", "--root", str(tmp_path),
                 "--baseline", str(baseline), "--json"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index('{'):])
    assert doc["counts"]["baselined"] == 1
    assert doc["stale_baseline"] == []


# -- CLI: --diff <git-ref> -------------------------------------------------

def test_cli_diff_reports_only_findings_since_ref(tmp_path, capsys):
    import shutil
    import subprocess

    if shutil.which("git") is None:
        pytest.skip("git not available")
    from distributedmandelbrot_tpu_torch.cli import main

    pkg = tmp_path / P / "serve"
    pkg.mkdir(parents=True)
    (pkg / "stateful.py").write_text(LOCK_CLASS)

    def git(*argv):
        subprocess.run(
            ["git", "-C", str(tmp_path),
             "-c", "user.email=ci@example.invalid", "-c", "user.name=ci",
             *argv], check=True, capture_output=True)

    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")

    baseline = tmp_path / "baseline.json"
    # Without --diff the pre-existing finding is reported...
    assert main(["check", "--root", str(tmp_path),
                 "--baseline", str(baseline)]) == 1
    # ...with --diff HEAD it is an ephemeral baseline entry, not stale.
    assert main(["check", "--root", str(tmp_path),
                 "--baseline", str(baseline), "--diff", "HEAD",
                 "--json"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index('{'):])
    assert doc["counts"]["total"] == 0
    assert doc["counts"]["baselined"] == 1
    assert doc["stale_baseline"] == []

    # A finding introduced after the ref is the only one reported.
    (pkg / "fresh.py").write_text(LOCK_CLASS.replace("Cache", "Fresh"))
    assert main(["check", "--root", str(tmp_path),
                 "--baseline", str(baseline), "--diff", "HEAD",
                 "--json"]) == 1
    out = capsys.readouterr().out
    doc = json.loads(out[out.index('{'):])
    assert doc["counts"]["total"] == 1
    assert doc["findings"][0]["path"].endswith("fresh.py")


def test_cli_diff_bad_ref_exits_2(tmp_path, capsys):
    import shutil

    if shutil.which("git") is None:
        pytest.skip("git not available")
    from distributedmandelbrot_tpu_torch.cli import main

    (tmp_path / P).mkdir()
    assert main(["check", "--root", str(tmp_path),
                 "--diff", "no-such-ref"]) == 2


# -- taint: wire input reaching dangerous sinks ----------------------------

TAINT_FILE = f"{P}/coordinator/handler.py"

TAINT_LOOP_FIRE = '''
from distributedmandelbrot_tpu_torch.net import framing


def handle(sock):
    n = framing.recv_u32(sock)
    out = []
    for _ in range(n):
        out.append(framing.recv_byte(sock))
    return out
'''


def test_taint_loop_fires_on_wire_range_bound():
    found = findings_for({TAINT_FILE: TAINT_LOOP_FIRE}, "taint-loop")
    assert len(found) == 1
    assert found[0].severity == "error"
    assert "range() bound" in found[0].message


def test_taint_loop_clean_after_validate_call():
    src = TAINT_LOOP_FIRE.replace(
        "    n = framing.recv_u32(sock)",
        "    n = validate_count(framing.recv_u32(sock), 4096)")
    assert findings_for({TAINT_FILE: src}, "taint-loop") == []


def test_taint_loop_clean_after_comparison_guard():
    src = TAINT_LOOP_FIRE.replace(
        "    out = []",
        "    if n > 4096:\n        raise ValueError(n)\n    out = []")
    assert findings_for({TAINT_FILE: src}, "taint-loop") == []


def test_taint_loop_clean_after_min_clamp():
    src = TAINT_LOOP_FIRE.replace(
        "    out = []",
        "    n = min(n, 4096)\n    out = []")
    assert findings_for({TAINT_FILE: src}, "taint-loop") == []


TAINT_ALLOC_FIRE = '''
from distributedmandelbrot_tpu_torch.net import framing


def read_payload(sock):
    length = framing.recv_u32(sock)
    return framing.recv_exact(sock, length)
'''


def test_taint_alloc_fires_on_wire_sized_read():
    found = findings_for({TAINT_FILE: TAINT_ALLOC_FIRE}, "taint-alloc")
    assert len(found) == 1
    assert "recv_exact" in found[0].message


def test_taint_alloc_fires_on_bytearray():
    src = TAINT_ALLOC_FIRE.replace(
        "    return framing.recv_exact(sock, length)",
        "    return bytearray(length)")
    found = findings_for({TAINT_FILE: src}, "taint-alloc")
    assert len(found) == 1
    assert "bytearray" in found[0].message


def test_taint_alloc_clean_after_payload_validator():
    src = TAINT_ALLOC_FIRE.replace(
        "    length = framing.recv_u32(sock)",
        "    length = validate_payload_length(framing.recv_u32(sock))")
    assert findings_for({TAINT_FILE: src}, "taint-alloc") == []


TAINT_INDEX_FIRE = '''
from distributedmandelbrot_tpu_torch.net import framing


def lookup(sock, table):
    i = framing.recv_u32(sock)
    return table[i]
'''


def test_taint_index_fires_on_wire_subscript():
    found = findings_for({TAINT_FILE: TAINT_INDEX_FIRE}, "taint-index")
    assert len(found) == 1
    assert "container index" in found[0].message


def test_taint_index_clean_after_len_guard():
    src = TAINT_INDEX_FIRE.replace(
        "    return table[i]",
        "    if i >= len(table):\n        return None\n    return table[i]")
    assert findings_for({TAINT_FILE: src}, "taint-index") == []


TAINT_STRUCT_FIRE = '''
import struct

from distributedmandelbrot_tpu_torch.net import framing


def read_array(sock):
    n = framing.recv_u32(sock)
    data = framing.recv_exact(sock, 4)
    return struct.unpack(f"<{n}I", data)
'''


def test_taint_struct_fires_on_wire_repeat_count():
    found = findings_for({TAINT_FILE: TAINT_STRUCT_FIRE}, "taint-struct")
    assert len(found) == 1
    assert "format" in found[0].message


def test_taint_struct_clean_with_constant_format():
    src = TAINT_STRUCT_FIRE.replace('f"<{n}I"', '"<4I"')
    assert findings_for({TAINT_FILE: src}, "taint-struct") == []


# Through-helper flows: the call graph carries taint across functions in
# both directions — a helper's tainted RETURN reaches the caller's sink,
# and a tainted ARGUMENT reaches the helper's sink.

TAINT_HELPER_RETURN = '''
import struct


class Handler:
    async def _read_len(self, reader):
        data = await reader.readexactly(4)
        (n,) = struct.unpack("<I", data)
        return n

    async def handle(self, reader):
        n = await self._read_len(reader)
        for _ in range(n):
            await reader.readexactly(16)
'''


def test_taint_flows_through_helper_return_via_callgraph():
    found = findings_for({TAINT_FILE: TAINT_HELPER_RETURN}, "taint-loop")
    assert len(found) == 1
    assert "range() bound" in found[0].message


TAINT_HELPER_PARAM = '''
from distributedmandelbrot_tpu_torch.net import framing


class Handler:
    def _alloc(self, n):
        return bytearray(n)

    def handle(self, sock):
        n = framing.recv_u32(sock)
        return self._alloc(n)
'''


def test_taint_flows_into_helper_param_via_callgraph():
    found = findings_for({TAINT_FILE: TAINT_HELPER_PARAM}, "taint-alloc")
    assert len(found) == 1
    assert "_alloc" in found[0].message


def test_taint_helper_param_clean_when_sanitized_before_call():
    src = TAINT_HELPER_PARAM.replace(
        "        return self._alloc(n)",
        "        n = validate_count(n, 4096)\n        return self._alloc(n)")
    assert findings_for({TAINT_FILE: src}, "taint-alloc") == []


def test_taint_out_of_scope_dirs_are_ignored():
    # storage/ only sees validated data; same source there is clean.
    assert findings_for({f"{P}/storage/handler.py": TAINT_LOOP_FIRE},
                        "taint-loop") == []


# -- exc: exception-path leaks and silent swallows -------------------------

EXC_FILE = f"{P}/coordinator/ingest.py"

EXC_LEAK_FIRE = '''
from distributedmandelbrot_tpu_torch.net import framing


class Ingest:
    async def ingest(self, reader, writer, w):
        token = self.scheduler.claim(w)
        if token is None:
            return
        framing.write_byte(writer, 0x20)
        await writer.drain()
        try:
            data = await framing.read_exact(reader, 16)
        except ConnectionError:
            self.scheduler.release_claim(w, token)
            raise
        self.scheduler.finish_claim(w, token)
'''


def test_exc_leak_fires_on_io_between_claim_and_try():
    found = findings_for({EXC_FILE: EXC_LEAK_FIRE}, "exc-leak")
    assert len(found) == 1
    assert found[0].severity == "error"
    assert "token" in found[0].message


def test_exc_leak_clean_when_io_moved_inside_guarded_try():
    src = EXC_LEAK_FIRE.replace(
        "        framing.write_byte(writer, 0x20)\n"
        "        await writer.drain()\n"
        "        try:\n"
        "            data = await framing.read_exact(reader, 16)",
        "        try:\n"
        "            framing.write_byte(writer, 0x20)\n"
        "            await writer.drain()\n"
        "            data = await framing.read_exact(reader, 16)")
    assert findings_for({EXC_FILE: src}, "exc-leak") == []


def test_exc_leak_clean_when_finally_releases():
    src = '''
class Ingest:
    async def ingest(self, writer, w):
        token = self.scheduler.claim(w)
        try:
            await writer.drain()
        finally:
            self.scheduler.release_claim(w, token)
'''
    assert findings_for({EXC_FILE: src}, "exc-leak") == []


def test_exc_leak_socket_fires_on_io_before_close():
    src = '''
import socket


def probe(host):
    sock = socket.create_connection((host, 80))
    sock.sendall(b"ping")
    sock.close()
'''
    found = findings_for({EXC_FILE: src}, "exc-leak")
    assert len(found) == 1
    assert "socket" in found[0].message


def test_exc_leak_socket_clean_when_returned_or_with():
    # Returning transfers ownership (worker client's _connect shape);
    # non-I/O setup calls in between are fine.
    src = '''
import socket


def dial(host):
    sock = socket.create_connection((host, 80))
    sock.setsockopt(1, 2, 3)
    return sock
'''
    assert findings_for({EXC_FILE: src}, "exc-leak") == []


def test_exc_swallow_fires_on_silent_overbroad_handler():
    src = '''
def best_effort(fn):
    try:
        fn()
    except Exception:
        pass
'''
    found = findings_for({EXC_FILE: src}, "exc-swallow")
    assert len(found) == 1
    assert found[0].severity == "warning"


def test_exc_swallow_clean_when_logged_counted_or_narrow():
    src = '''
import logging

logger = logging.getLogger(__name__)


def logged(fn):
    try:
        fn()
    except Exception:
        logger.debug("probe failed", exc_info=True)


def counted(fn, counters):
    try:
        fn()
    except Exception:
        counters.inc("probe_failures")


def narrow(fn):
    try:
        fn()
    except ValueError:
        pass
'''
    assert findings_for({EXC_FILE: src}, "exc-swallow") == []


def test_exc_swallow_clean_when_exception_bound_and_used():
    # The embed.py shape: the handler stores the exception for a later
    # re-raise — that is handling, not swallowing.
    src = '''
class Runner:
    def run(self, fn):
        try:
            fn()
        except BaseException as e:
            self._error = e
'''
    assert findings_for({EXC_FILE: src}, "exc-swallow") == []


# -- CLI: --severity and comma-separated --rules ---------------------------

def test_cli_severity_filter(tmp_path, capsys):
    from distributedmandelbrot_tpu_torch.cli import main
    pkg = tmp_path / P / "coordinator"
    pkg.mkdir(parents=True)
    # One error (taint-loop) + one warning (exc-swallow).
    (pkg / "handler.py").write_text(
        TAINT_LOOP_FIRE
        + "\n\ndef quiet(fn):\n    try:\n        fn()\n"
          "    except Exception:\n        pass\n")
    baseline = tmp_path / "baseline.json"

    assert main(["check", "--root", str(tmp_path), "--baseline",
                 str(baseline), "--json"]) == 1
    out = capsys.readouterr().out
    doc = json.loads(out[out.index('{'):])
    assert doc["counts"]["error"] == 1
    assert doc["counts"]["warning"] == 1

    assert main(["check", "--root", str(tmp_path), "--baseline",
                 str(baseline), "--severity", "error", "--json"]) == 1
    out = capsys.readouterr().out
    doc = json.loads(out[out.index('{'):])
    assert doc["counts"]["total"] == 1
    assert doc["findings"][0]["rule"] == "taint-loop"


def test_cli_rules_accepts_comma_separated_families(tmp_path, capsys):
    from distributedmandelbrot_tpu_torch.cli import main
    pkg = tmp_path / P / "coordinator"
    pkg.mkdir(parents=True)
    (pkg / "handler.py").write_text(TAINT_LOOP_FIRE)
    baseline = tmp_path / "baseline.json"

    assert main(["check", "--root", str(tmp_path), "--baseline",
                 str(baseline), "--rules", "taint,exc", "--json"]) == 1
    out = capsys.readouterr().out
    doc = json.loads(out[out.index('{'):])
    assert {f["rule"] for f in doc["findings"]} == {"taint-loop"}
    # Families outside the selection are filtered even if they'd fire.
    assert main(["check", "--root", str(tmp_path), "--baseline",
                 str(baseline), "--rules", "exc,res", "--json"]) == 0


# -- CLI: --diff with a file deleted since the ref -------------------------

def test_cli_diff_survives_deleted_file(tmp_path, capsys):
    import shutil
    import subprocess

    if shutil.which("git") is None:
        pytest.skip("git not available")
    from distributedmandelbrot_tpu_torch.cli import main

    pkg = tmp_path / P / "serve"
    pkg.mkdir(parents=True)
    (pkg / "stateful.py").write_text(LOCK_CLASS)
    (pkg / "doomed.py").write_text(LOCK_CLASS.replace("Cache", "Doomed"))

    def git(*argv):
        subprocess.run(
            ["git", "-C", str(tmp_path),
             "-c", "user.email=ci@example.invalid", "-c", "user.name=ci",
             *argv], check=True, capture_output=True)

    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")

    # Delete a file that had findings at the ref: its ref fingerprints
    # match nothing now, and --diff must treat that as expected churn
    # (rc 0, no stale entries, no crash), not a lookup error.
    (pkg / "doomed.py").unlink()
    baseline = tmp_path / "baseline.json"
    assert main(["check", "--root", str(tmp_path),
                 "--baseline", str(baseline), "--diff", "HEAD",
                 "--json"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index('{'):])
    assert doc["counts"]["total"] == 0
    assert doc["stale_baseline"] == []


# -- held against the reference --------------------------------------------

REF = "distributedmandelbrot_tpu"


def _to_ref(text: str) -> str:
    return re.sub(rf"\b{P}\b", REF, text)


def _planted() -> dict:
    """One firing project per carried family."""
    proto_gap = dict(PROTO_SOURCES)
    proto_gap[PROTO_SERVER] = SERVER_SRC.replace(
        "        if purpose == proto.PURPOSE_REQUEST:\n", "        if True:\n")
    fsm_client = FSM_QUERY_CLIENT.replace(
        "        status = framing.recv_byte(sock)",
        "        framing.send_all(sock, proto.RENDER_QUERY_TAIL.pack(0, 0))\n"
        "        status = framing.recv_byte(sock)")
    return {
        "locks": {LOCK_GUARD_FIRE: LOCK_CLASS},
        "async": {f"{P}/serve/h.py": (
            f"import time\nfrom {P}.net import framing\n\n"
            "class Handler:\n    async def handle(self, sock):\n"
            "        time.sleep(0.1)\n        framing.send_u32(sock, 1)\n")},
        "wire": {f"{P}/serve/proto_copy.py":
                 'import struct\nHEADER = struct.Struct("<II")\n',
                 f"{P}/net/protocol.py":
                 'import struct\nQUERY = struct.Struct("<III")\n'
                 'QUERY_WIRE_SIZE = 16\n'},
        "proto": proto_gap,
        "res": {f"{P}/worker/r.py": (
            "import threading\n\nclass R:\n    def start(self):\n"
            "        t = threading.Thread(target=self._run)\n"
            "        t.start()\n"
            "        threading.Thread(target=self._pump).start()\n")},
        "obs": {NAMES_MOD: NAMES_SRC, f"{P}/worker/w.py": (
            "class W:\n    def f(self):\n"
            '        self.counters.inc("tils_done")\n')},
        "taint": {TAINT_FILE: TAINT_LOOP_FIRE},
        "exc": {EXC_FILE: EXC_LEAK_FIRE},
        "fsm": {FSM_CLIENT_REL: fsm_client, FSM_SERVER_REL: FSM_QUERY_SERVER},
    }


def _as_rows(findings, rename) -> list:
    return [(f.rule, f.severity, rename(f.path), f.line, rename(f.message))
            for f in findings]


@pytest.mark.parametrize("family", ["locks", "async", "wire", "proto", "res",
                                    "obs", "taint", "exc", "fsm"])
def test_carried_family_finds_what_the_reference_finds(family):
    """The same planted project, under each package's prefix, gives the
    same findings from the port's check and the JAX package's."""
    from distributedmandelbrot_tpu import analysis as ref_analysis
    sources = _planted()[family]
    got = _as_rows(check_project(Project.from_sources(sources)), _to_ref)
    want = _as_rows(ref_analysis.check_project(
        ref_analysis.Project.from_sources(
            {_to_ref(k): _to_ref(v) for k, v in sources.items()})),
        lambda s: s)
    assert got == want
    assert any(all_rules()[rule].family == family for rule, *_ in got)


def test_list_rules_differs_from_the_reference_only_in_the_jax_family(
        capsys):
    from distributedmandelbrot_tpu.cli import main as ref_main
    from distributedmandelbrot_tpu_torch.cli import main
    assert main(["check", "--list-rules"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert ref_main(["check", "--list-rules"]) == 0
    ref = capsys.readouterr().out.splitlines()

    def ids(lines, prefix):
        return ({ln.split()[0] for ln in lines
                 if not ln.startswith(prefix)},
                {ln.split()[0][len(prefix):] for ln in lines
                 if ln.startswith(prefix)})

    port_rest, port_own = ids(port, "torch-")
    ref_rest, ref_own = ids(ref, "jax-")
    assert port_rest == ref_rest
    assert port_own == {"host-sync", "dtype-mix"} < ref_own
    assert [ln for ln in port if not ln.startswith("torch-")] == \
        [ln for ln in ref if not ln.startswith("jax-")]


def test_fsm_dump_equals_the_reference_dump_after_the_rename(tmp_path):
    from distributedmandelbrot_tpu.cli import main as ref_main
    from distributedmandelbrot_tpu_torch.cli import main
    port, ref = tmp_path / "port.dot", tmp_path / "ref.dot"
    assert main(["check", "--fsm-dump", str(port)]) == 0
    assert ref_main(["check", "--fsm-dump", str(ref)]) == 0
    assert port.read_text() == re.sub(
        rf"\b{REF}\b", P, ref.read_text())
    assert port.stat().st_size > 0
