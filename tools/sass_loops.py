"""Count the instructions of each loop of a kernel in `cuobjdump -sass`
output: the issue floor of a loop-bound kernel is its loop's instructions
times its trips, over the card's issue rate.

    cuobjdump -sass build/torch_ext/libtbt_*.so > sass.txt
    python3 tools/sass_loops.py sass.txt simplex_wide_kernel

For every function whose (mangled) name contains the given text, prints
one JSON line: the function's name, its instruction count, and each loop
(a backward branch: the instructions from its target to the branch) with
its instruction count and how many of them are MUFU (the special-function
unit: the approximations inside expf, logf and the divisions) and F*
float arithmetic. Instructions past the last EXIT (padding) are not
counted.
"""

import json
import re
import sys

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a branch's target: a label, or an address (cuobjdump of a cubin)
_TARGET = re.compile(r"BRA\s+(?:!?U?P\w+,\s*)?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_FUNC = re.compile(r"Function : (\S+)")


def functions(text):
    """name -> [(address, instruction)], labels -> address, per function."""
    out, name = {}, None
    pending = []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            out[name] = ([], {})
            pending = []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                out[name][1][lab] = addr
            pending = []
            out[name][0].append((addr, m.group(2)))
    return out


def loops(instrs, labels):
    """[(start, end, instructions)] of each backward branch."""
    addr_index = {a: i for i, (a, _) in enumerate(instrs)}
    found = []
    for i, (a, ins) in enumerate(instrs):
        if "BRA" not in ins:
            continue
        m = _TARGET.search(ins)
        if not m or (m.group(1) and m.group(1) not in labels):
            continue
        t = labels[m.group(1)] if m.group(1) else int(m.group(2), 16)
        if t <= a and t in addr_index:
            found.append((t, a, instrs[addr_index[t]: i + 1]))
    return found


def summary(name, instrs, labels):
    last_exit = max((i for i, (_, s) in enumerate(instrs) if s.split()[0:1] == ["EXIT"]
                     or " EXIT" in s), default=len(instrs) - 1)
    body = instrs[: last_exit + 1]

    def count(seq):
        ops = [s.split()[1] if s.startswith("@") else s.split()[0] for _, s in seq]
        return {"instructions": len(ops),
                "mufu": sum(o.startswith("MUFU") for o in ops),
                "float": sum(o.startswith(("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL",
                                           "FCHK")) for o in ops)}

    return {"function": name, **count(body),
            "loops": [{"start": hex(s), "end": hex(e), **count(seq)}
                      for s, e, seq in loops(body, labels)]}


def main(path, needle):
    text = open(path).read()
    for name, (instrs, labels) in functions(text).items():
        if needle in name:
            print(json.dumps(summary(name, instrs, labels)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
