"""The ctypes mirrors of the kernels' argument structs match the C structs.

Every ``extern "C"`` launcher in ``attention_lvcsr_torch/csrc/*.cu`` takes
its arguments as one struct, and its wrapper in ``ops/*.py`` fills a
``ctypes.Structure`` whose docstring names that struct ("Mirror of
``struct X`` in csrc/F.cu").  A field left out of step shifts every field
after it and corrupts a launch without an error, and only the card would
show it.  Here, on the CPU, each C struct is parsed and compared with its
mirror field by field: names, order and C types (a pointer is
``c_void_p``, an ``int`` ``c_int``, a ``float`` ``c_float``, a nested
struct its own mirror, arrays their length)."""
import ctypes
import glob
import importlib
import inspect
import os
import re

import pytest

import attention_lvcsr_torch

PKG = os.path.dirname(attention_lvcsr_torch.__file__)
CSRC = os.path.join(PKG, "csrc")
MIRROR = re.compile(r"Mirror of ``struct (\w+)`` in csrc/(\w+\.cu)")
SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float,
           "unsigned": ctypes.c_uint}


def _mirrors():
    """{struct name: (ctypes class, source file)} over ops/*.py."""
    found = {}
    for path in sorted(glob.glob(os.path.join(PKG, "ops", "*.py"))):
        name = os.path.basename(path)[:-3]
        module = importlib.import_module(f"attention_lvcsr_torch.ops.{name}")
        for _, cls in inspect.getmembers(module, inspect.isclass):
            m = MIRROR.search(cls.__doc__ or "")
            if m and issubclass(cls, ctypes.Structure):
                found[m.group(1)] = (cls, m.group(2))
    return found


def _c_struct(source, name):
    """[(field name, C type, is pointer, array length or None)] of
    ``struct name`` in csrc/source."""
    text = open(os.path.join(CSRC, source)).read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}
    body = re.search(r"^struct %s \{(.*?)^\};" % name, text, re.S | re.M)
    assert body, f"struct {name} not found in {source}"
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body.group(1)).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.fullmatch(r"(?:const )?(\w+)\s*(\*?)\s*(.*)", decl)
        ctype, pointer = m.group(1), bool(m.group(2))
        for item in m.group(3).split(","):
            item = item.strip()
            arr = re.fullmatch(r"(\w+)\[(\w+)\]", item)
            if arr:
                item, n = arr.group(1), arr.group(2)
                length = int(n) if n.isdigit() else consts[n]
            else:
                length = None
            fields.append((item, ctype, pointer, length))
    return fields


def _launcher_structs():
    """The argument structs of every extern "C" launcher."""
    found = set()
    for path in glob.glob(os.path.join(CSRC, "*.cu")):
        found.update(re.findall(r'extern "C" int \w+\(const (\w+)\* ',
                                open(path).read()))
    return sorted(found)


MIRRORS = _mirrors()


def test_every_launcher_struct_has_a_mirror():
    structs = _launcher_structs()
    assert len(structs) >= 10
    assert sorted(set(structs) - set(MIRRORS)) == []


@pytest.mark.parametrize("struct", sorted(MIRRORS))
def test_mirror_matches_the_c_struct(struct):
    cls, source = MIRRORS[struct]
    by_class = {c: s for s, (c, _) in MIRRORS.items()}
    c_fields = _c_struct(source, struct)
    assert [f[0] for f in cls._fields_] == [f[0] for f in c_fields], \
        f"{cls.__qualname__} fields out of step with struct {struct}"
    for (name, ptype), (_, ctype, pointer, length) in zip(cls._fields_,
                                                          c_fields):
        if length is not None:
            assert issubclass(ptype, ctypes.Array) \
                and ptype._length_ == length, name
            ptype = ptype._type_
        if pointer:
            assert ptype is ctypes.c_void_p, name
        elif ctype in SCALARS:
            assert ptype is SCALARS[ctype], name
        else:
            assert by_class.get(ptype) == ctype, name


@pytest.mark.parametrize("struct,fields", [
    ("AttentionEnergyArgs", ("tile", "slices")),
    ("DecodeScoreArgs", ("cluster",))])
def test_launch_plans_travel_in_the_structs(struct, fields):
    """The module path's kernels take their launch plan in their argument
    struct (the energy kernel's frame tile and M slices, the score
    kernel's cluster size), as its last fields, on both sides."""
    cls, source = MIRRORS[struct]
    names = [f[0] for f in _c_struct(source, struct)]
    assert tuple(names[-len(fields):]) == fields
    assert tuple(n for n, _ in cls._fields_[-len(fields):]) == fields
    assert all(t is ctypes.c_int for _, t in cls._fields_[-len(fields):])


@pytest.mark.parametrize("struct", ["BeamLoopArgs", "DecoderArgs"])
def test_content_flag_travels_in_the_structs(struct):
    """The content-only attention branch of the loop decode and of the
    training decoder is an ``int content`` of the argument struct on both
    sides, zero by default: a struct filled without it runs the conv
    attention the kernels ran before the branch."""
    cls, source = MIRRORS[struct]
    c_fields = {f[0]: f for f in _c_struct(source, struct)}
    assert c_fields["content"][1:] == ("int", False, None)
    assert dict(cls._fields_)["content"] is ctypes.c_int
    assert cls().content == 0


@pytest.mark.parametrize("struct,fields", [
    ("BeamLoopArgs", (("normalizer", "int"), ("mse_cost", "int"),
                      ("energy_b", "float"))),
    ("DecoderArgs", (("normalizer", "int"),))])
def test_normalizer_and_cost_fields_travel_in_the_structs(struct, fields):
    """The logistic/relu normalizers (``normalizer`` 1, 2) and the task
    loss's costs (``mse_cost``) are fields of the argument structs on both
    sides, right after ``content``, zero by default: a struct filled
    without them runs softmax and the log-likelihood."""
    cls, source = MIRRORS[struct]
    names = [f[0] for f in _c_struct(source, struct)]
    at = names.index("content") + 1
    assert tuple(names[at:at + len(fields)]) == tuple(n for n, _ in fields)
    c_fields = {f[0]: f for f in _c_struct(source, struct)}
    mirror = dict(cls._fields_)
    for name, ctype in fields:
        assert c_fields[name][1:] == (ctype, False, None)
        assert mirror[name] is SCALARS[ctype]
        assert getattr(cls(), name) == 0


def test_decoder_bias_and_scale_buffers_travel_in_the_struct():
    """The training decoder's energy bias (read) and its normalizer's
    per-frame scales (written forward, read backward) are pointers of
    ``DecoderArgs`` on both sides, after the weight-gradient partials."""
    cls, source = MIRRORS["DecoderArgs"]
    names = [f[0] for f in _c_struct(source, "DecoderArgs")]
    assert names[names.index("dv") + 1:names.index("dv") + 3] == [
        "e_bias", "gsc"]
    mirror = dict(cls._fields_)
    assert mirror["e_bias"] is ctypes.c_void_p
    assert mirror["gsc"] is ctypes.c_void_p


@pytest.mark.parametrize("struct,fields", [
    ("BeamLoopArgs", ("n_filters", "post_act", "maxout", "prior_mean")),
    ("DecoderArgs", ("n_filters", "prior_mean")),
    ("DecodeScoreArgs", ("prior_mean", "cluster"))])
def test_filter_activation_and_mean_prior_fields_travel_in_the_structs(
        struct, fields):
    """The conv filters (``n_filters``, 0 read as one), the loop's
    post-merge activation (``post_act``: 0 tanh, 1 relu, 2 sigmoid, 3
    identity, 4 maxout of ``maxout`` pieces) and the mean prior
    (``prior_mean``) are ``int`` fields at the end of the structs on both
    sides (the score kernel's before its launch plan), zero by default: a
    struct filled without them runs one filter, tanh and the prior
    ``prior_median`` names, as before them."""
    cls, source = MIRRORS[struct]
    c_fields = _c_struct(source, struct)
    names = [f[0] for f in c_fields]
    # only a stacked decoder's fields come after them
    end = len(names) - len(STACK_FIELDS.get(struct, ()))
    assert tuple(names[end - len(fields):end]) == fields
    assert tuple(n for n, _ in cls._fields_[end - len(fields):end]) == fields
    by_name = {f[0]: f for f in c_fields}
    for name in fields:
        assert by_name[name][1:] == ("int", False, None)
        assert dict(cls._fields_)[name] is ctypes.c_int
        assert getattr(cls(), name) == 0


# the stacked decoder's fields, last in the structs: the interlayer tables
# (the loop's, layer-major; the training backward's packed transposes)
# and the number of layers
STACK_FIELDS = {
    "BeamLoopArgs": (("inter_in_w", "float*"), ("inter_gate_w", "float*"),
                     ("dec_stack", "int")),
    "DecoderArgs": (("p_ibT", "float*"), ("dec_stack", "int"))}


@pytest.mark.parametrize("struct", sorted(STACK_FIELDS))
def test_stack_fields_travel_in_the_structs(struct):
    """A stacked decoder's interlayer tables and ``dec_stack`` are the
    last fields of the loop's and the training decoder's structs on both
    sides, null and zero by default: a struct filled without them runs
    one decoder layer, as before them."""
    fields = STACK_FIELDS[struct]
    cls, source = MIRRORS[struct]
    c_fields = _c_struct(source, struct)
    assert [f[0] for f in c_fields[-len(fields):]] == [n for n, _ in fields]
    assert [n for n, _ in cls._fields_[-len(fields):]] == [
        n for n, _ in fields]
    by_name = {f[0]: f for f in c_fields}
    blank = cls()
    for name, ctype in fields:
        pointer = ctype.endswith("*")
        assert by_name[name][1:] == (ctype.rstrip("*"), pointer, None), name
        assert dict(cls._fields_)[name] is (ctypes.c_void_p if pointer
                                            else ctypes.c_int)
        assert not getattr(blank, name)


@pytest.mark.parametrize("struct,inner", [("GruWideArgs", "GruArgs"),
                                          ("GruBwdWideArgs", "GruBwdArgs")])
def test_wide_gru_structs_wrap_the_resident_ones(struct, inner):
    """The GRU kernels' wide instances take the resident instance's struct
    whole, then each direction's packed weights: the wrappers fill the
    resident struct once for either instance."""
    cls, source = MIRRORS[struct]
    assert _c_struct(source, struct) == [("a", inner, False, None),
                                         ("pack", "float", True, 2)]
    assert cls._fields_[0][1] is MIRRORS[inner][0]
    assert issubclass(cls._fields_[1][1], ctypes.Array)
    assert cls._fields_[1][1]._type_ is ctypes.c_void_p
