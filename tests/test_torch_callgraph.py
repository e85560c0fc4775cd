"""The port's ``analysis/callgraph.py`` (carried from the JAX package),
under the JAX package's own tests of the v2 engine layer.

Covers exactly what the module's docstring promises to resolve
(``self.m``, ``self.attr.m`` via inferred attribute types, module
functions, project imports, ``ClassName()`` -> ``__init__``, lexical
inheritance) and, just as deliberately, what it must leave unresolved:
callbacks, ``getattr``, duplicate class names with no disambiguating
import.  Reachability must terminate on cycles and report caller paths.
"""

from __future__ import annotations

from distributedmandelbrot_tpu_torch.analysis import Project
from distributedmandelbrot_tpu_torch.analysis.callgraph import graph_for

P = "distributedmandelbrot_tpu_torch"


def graph_of(sources: dict[str, str]):
    return graph_for(Project.from_sources(sources))


def callees_of(graph, qual: str) -> list:
    return [site.callee for site in graph.calls.get(qual, [])]


# -- resolution ------------------------------------------------------------

def test_resolves_self_method_and_module_function():
    g = graph_of({f"{P}/worker/a.py": '''
def helper():
    pass

class A:
    def top(self):
        self.step()
        helper()

    def step(self):
        pass
'''})
    assert callees_of(g, f"{P}/worker/a.py::A.top") == [
        f"{P}/worker/a.py::A.step", f"{P}/worker/a.py::helper"]


def test_resolves_attr_method_via_init_annotation_and_construction():
    g = graph_of({f"{P}/worker/b.py": '''
class Sched:
    def next(self):
        pass

class Store:
    def put(self):
        pass

class Owner:
    def __init__(self, sched: Sched):
        self.sched = sched
        self.store = Store()

    def run(self):
        self.sched.next()
        self.store.put()
'''})
    assert callees_of(g, f"{P}/worker/b.py::Owner.run") == [
        f"{P}/worker/b.py::Sched.next", f"{P}/worker/b.py::Store.put"]


def test_resolves_imports_symbol_module_alias_and_constructor():
    util = f"{P}/net/util.py"
    user = f"{P}/worker/c.py"
    g = graph_of({
        util: '''
def read_u32(sock):
    pass

class Codec:
    def __init__(self):
        pass
''',
        user: f'''
from {P}.net import util
from {P}.net.util import read_u32, Codec

def direct(sock):
    read_u32(sock)

def via_module(sock):
    util.read_u32(sock)

def construct():
    return Codec()
'''})
    assert callees_of(g, f"{user}::direct") == [f"{util}::read_u32"]
    assert callees_of(g, f"{user}::via_module") == [f"{util}::read_u32"]
    assert callees_of(g, f"{user}::construct") == [f"{util}::Codec.__init__"]


def test_resolves_inherited_method_through_lexical_base():
    g = graph_of({f"{P}/serve/d.py": '''
class Base:
    def common(self):
        pass

class Child(Base):
    def run(self):
        self.common()
'''})
    assert callees_of(g, f"{P}/serve/d.py::Child.run") == [
        f"{P}/serve/d.py::Base.common"]


# -- conservatism ----------------------------------------------------------

def test_unresolvable_calls_stay_none():
    g = graph_of({f"{P}/worker/e.py": '''
import json

class E:
    def run(self, cb):
        cb()
        getattr(self, "dynamic")()
        json.dumps({})
'''})
    # getattr(...)() is two call sites (the getattr and the result).
    assert callees_of(g, f"{P}/worker/e.py::E.run") == [None] * 4


def test_duplicate_class_names_without_import_stay_unresolved():
    # Worker in two modules, neither imported here: picking one would be
    # a guess, and the rules must treat a guess as unknown.
    g = graph_of({
        f"{P}/worker/w1.py": "class Worker:\n    def go(self):\n        pass\n",
        f"{P}/serve/w2.py": "class Worker:\n    def go(self):\n        pass\n",
        f"{P}/obs/user.py": '''
class U:
    def __init__(self, w: "Worker"):
        self.w = w

    def run(self):
        self.w.go()
''',
    })
    assert callees_of(g, f"{P}/obs/user.py::U.run") == [None]


def test_nested_defs_not_walked_as_enclosing_function():
    g = graph_of({f"{P}/worker/f.py": '''
def target():
    pass

def outer():
    def later():
        target()
    return later
'''})
    # outer() itself never calls target; the nested body runs later.
    assert callees_of(g, f"{P}/worker/f.py::outer") == []
    assert callees_of(g, f"{P}/worker/f.py::outer.<locals>.later") == []


# -- reachability ----------------------------------------------------------

def test_reachable_reports_paths_and_terminates_on_cycles():
    g = graph_of({f"{P}/worker/g.py": '''
class G:
    def a(self):
        self.b()

    def b(self):
        self.c()

    def c(self):
        self.a()
'''})
    a = f"{P}/worker/g.py::G.a"
    b = f"{P}/worker/g.py::G.b"
    c = f"{P}/worker/g.py::G.c"
    reached = g.reachable(a)
    assert set(reached) == {b, c}
    # The path is the caller chain, nearest-first, excluding the target.
    assert reached[b] == (a,)
    assert reached[c] == (a, b)


def test_graph_is_cached_per_project():
    project = Project.from_sources({f"{P}/worker/h.py": "def f():\n    pass\n"})
    assert graph_for(project) is graph_for(project)
