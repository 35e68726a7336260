"""The launch layer of the hand-written kernels (ops/cuda/_lib.py), on the CPU.

Each C entry ``rps_<name>(const void* packed, int size)`` of csrc/*.cu takes
one packed record, the bytes of ``struct rps_<name>_args``; the binding packs
it with ``struct`` from ``_lib.RECORDS``.  A drift between the two would pass
wrong arguments (or cut a pointer to 32 bits) without a word, so these tests
read the C declarations and hold the binding to them: every entry's parameters
against the binding's argument types, in count and kind, and every record's
fields, offsets and size against its C struct, laid out as the C compiler
lays it out.  Then the launch layer's own checks that run without a card.
"""

from __future__ import annotations

import ctypes
import re
import struct

import pytest
import torch

from rust_particle_system_tpu_torch.ops.cuda import _lib
from rust_particle_system_tpu_torch.ops.cuda import toolchain_probe as K13

_CTYPE_KIND = {ctypes.c_char_p: "P", ctypes.c_void_p: "P", ctypes.c_int: "i",
               ctypes.c_float: "f"}


def _sources() -> str:
    return "\n".join(p.read_text() for p in sorted(_lib.CSRC.glob("*.cu")))


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", re.sub(r"/\*.*?\*/", "", src, flags=re.S))


def _kind(decl: str) -> str:
    """'P', 'i' or 'f' of a C parameter or field type."""
    decl = decl.replace("const", " ")
    if "*" in decl:
        return "P"
    words = decl.split()
    if words[0] == "int":
        return "i"
    if words[0] == "float":
        return "f"
    raise AssertionError(f"unexpected C type in {decl!r}")


def _entries(src: str) -> dict:
    """{entry: [parameter kinds]} of every extern "C" int rps_*(...)."""
    out = {}
    for name, params in re.findall(r'extern "C" int (rps_\w+)\(([^)]*)\)', src):
        out[name] = [_kind(p) for p in params.split(",")]
    return out


def _records(src: str) -> dict:
    """{struct name: [(kind, count)]} of every struct rps_*_args, with the
    aliases (``using rps_x_args = rps_y_args;``) resolved."""
    out = {}
    for name, body in re.findall(r"struct (rps_\w+_args)\s*\{([^}]*)\};", src):
        fields = []
        for stmt in body.split(";"):
            stmt = stmt.strip()
            if not stmt:
                continue
            base, names = re.match(r"((?:const\s+|unsigned\s+)*\w+)\s*(.*)", stmt).groups()
            for item in names.split(","):
                arr = re.search(r"\[(\d+)\]", item)
                fields.append(("P" if "*" in item else _kind(base),
                               int(arr.group(1)) if arr else 1))
        out[name] = fields
    for alias, target in re.findall(r"using (rps_\w+_args) = (rps_\w+_args);", src):
        out[alias] = out[target]
    return out


def _c_layout(fields) -> tuple:
    """(offsets, size) of a C struct of these fields: each at its natural
    alignment, the size padded to the largest alignment."""
    sizes = {"P": 8, "i": 4, "f": 4}
    off, offsets, align = 0, [], 1
    for kind, count in fields:
        a = sizes[kind]
        off = -(-off // a) * a
        for j in range(count):
            offsets.append(off + j * a)
        off += count * a
        align = max(align, a)
    return offsets, -(-off // align) * align


def _py_layout(fmt: str) -> tuple:
    """(offsets, size) of the binding's record: each field's offset by struct."""
    offsets = []
    items = [(int(n) if n else 1, c) for n, c in re.findall(r"(\d*)([Pif])", fmt)]
    prefix = ""
    for count, code in items:
        for _ in range(count):
            start = struct.calcsize(prefix + "0" + code)
            offsets.append(start)
            prefix += code
    return offsets, struct.calcsize(fmt + "0P")


def test_every_entry_has_a_record_and_a_binding():
    src = _strip_comments(_sources())
    entries = _entries(src)
    assert set(entries) == set(_lib.RECORDS), (
        f"entries without a binding: {set(entries) - set(_lib.RECORDS)}; bindings without "
        f"an entry: {set(_lib.RECORDS) - set(entries)}")
    records = _records(src)
    for name in entries:
        assert f"{name}_args" in records, f"{name} has no struct {name}_args"


@pytest.mark.parametrize("name", sorted(_lib.RECORDS))
def test_entry_parameters_match_the_binding(name):
    """Count and kind (pointer, int, float) of the C parameters against the
    ctypes argument types every entry is bound with."""
    params = _entries(_strip_comments(_sources()))[name]
    assert params == [_CTYPE_KIND[t] for t in _lib.ARGTYPES]


@pytest.mark.parametrize("name", sorted(_lib.RECORDS))
def test_record_layout_matches_its_c_struct(name):
    fields = _records(_strip_comments(_sources()))[f"{name}_args"]
    want = "".join(kind * count for kind, count in fields)
    fmt = _lib.RECORDS[name]
    got = "".join(code * (int(n) if n else 1) for n, code in re.findall(r"(\d*)([Pif])", fmt))
    assert got == want, f"{name}: binding {fmt} vs C fields {want}"
    assert want.endswith("P"), "the stream is the record's last field"
    assert _py_layout(fmt) == _c_layout(fields)
    assert _lib.kernel(name).record.size == _c_layout(fields)[1]


def test_a_record_keeps_64_bit_pointers():
    """A pointer above 4 GiB survives the record whole (ctypes would cut a
    pointer passed as a plain int to 32 bits)."""
    launch = _lib.kernel("rps_probe_copy")
    far = 0x7F12_3456_7890
    packed = launch.record.pack(far, far + 4096, 1024, 1.0, far + 8)
    x, o, n, scale, stream = launch.record.unpack(packed)
    assert (x, o, n, scale, stream) == (far, far + 4096, 1024, 1.0, far + 8)
    with pytest.raises(struct.error):
        launch.record.pack(far, far, 1024, 1.0)  # a field missing


def test_dispatch_takes_the_plain_version_only_on_the_cpu():
    assert _lib.dispatch(torch.zeros(4)) == "plain"
    with pytest.raises(ValueError, match="unsupported device"):
        _lib.dispatch(torch.zeros(4, device="meta"))


@pytest.mark.parametrize("check", [_lib.require_cuda, _lib.require_cuda_planes])
def test_kernel_input_checks_refuse_cpu_tensors(check):
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        check(torch.zeros(4))


def test_wrappers_check_shapes_before_dispatch():
    """A wrapper's shape checks run for every device, before the plain version
    or the kernel is chosen."""
    with pytest.raises(ValueError, match="multiply"):
        K13.dot_tf32(torch.zeros((2, 8)), torch.zeros((4, 8)))
    assert torch.equal(K13.copy_ids(torch.arange(8.0)), torch.arange(8.0))


def test_empty_f32_gives_separate_float32_outputs():
    like = torch.zeros((3, 4, 8))
    same, other = _lib.empty_f32(2, (3, 4, 8), like), _lib.empty_f32(3, (2, 5), like)
    assert [tuple(t.shape) for t in same + other] == [(3, 4, 8)] * 2 + [(2, 5)] * 3
    assert all(t.dtype == torch.float32 and t.device == like.device and t.is_contiguous()
               for t in same + other)
    assert len({t.data_ptr() for t in same + other}) == 5


def test_launcher_passes_the_record_and_raises_on_a_cuda_error(monkeypatch):
    """The launcher packs its fields and torch's current stream (device -1)
    into one record and passes (record bytes, size): the kinds ARGTYPES
    declares.  A nonzero return (a refused launch) raises."""
    calls, streams = [], []

    class FakeLibrary:
        def __getattr__(self, name):
            def entry(record, size):
                calls.append((name, record, size))
                return 0 if len(calls) == 1 else 700
            return entry

    def raw_stream(device):
        streams.append(device)
        return 0x7F00_DEAD_BEE0

    monkeypatch.setattr(_lib, "_lib", FakeLibrary())
    monkeypatch.setattr(_lib, "_raw_stream", raw_stream)
    launch = _lib.kernel("rps_probe_copy")
    launch(0x7F12_3456_7890, 0x7F12_3456_A890, 1024, 1.0)
    name, record, size = calls[0]
    assert name == "rps_probe_copy" and streams == [-1]
    assert isinstance(record, bytes) and isinstance(size, int) and len(record) == size
    assert launch.record.unpack(record) == (0x7F12_3456_7890, 0x7F12_3456_A890, 1024, 1.0,
                                            0x7F00_DEAD_BEE0)
    with pytest.raises(RuntimeError, match="rps_probe_copy: CUDA error 700"):
        launch(1, 2, 3, 1.0)


def test_pad8_fills_a_record_array_and_refuses_more():
    assert _lib.pad8([5, 6]) == (5, 6, 0, 0, 0, 0, 0, 0)
    with pytest.raises(ValueError, match="at most 8"):
        _lib.pad8(list(range(9)))
