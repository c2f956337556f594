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
counted. With --blocks each loop also lists its basic blocks (cut at
every branch and branch target) with the same counts and their loads
(LDG global, LDS shared): a loop whose body branches on a uniform value,
as the value kernel's walk over runs branches on a run's term set, is
read block by block. It also lists the loop's repeats: a sequence of
blocks that recurs at least four times in a row, with its instructions
and MUFU a repeat. The walk unrolls a block of rows, so the repeats of a
term set whose row has branches (the {absv, sp} rows: the checks inside
expf and log1pf) are its rows, and instructions a row over 132 SMs x 4
schedulers x 1.98 GHz is the set's issue floor a row; a set whose rows
are branch-free ({quad}) shows as one block of all the unrolled rows.

    python3 tools/sass_loops.py sass.txt run_kernel --blocks
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


def _op(ins):
    return ins.split()[1] if ins.startswith("@") else ins.split()[0]


def count(seq, loads=False):
    ops = [_op(s) for _, s in seq]
    out = {"instructions": len(ops),
           "mufu": sum(o.startswith("MUFU") for o in ops),
           "float": sum(o.startswith(("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL",
                                      "FCHK")) for o in ops)}
    if loads:
        out["ldg"] = sum(o.startswith("LDG") for o in ops)
        out["lds"] = sum(o.startswith("LDS") for o in ops)
    return out


def blocks(seq, labels):
    """The basic blocks of an instruction sequence: cut before every branch
    target and after every branch."""
    targets = set(labels.values())
    for _, ins in seq:
        m = _TARGET.search(ins) if "BRA" in ins else None
        if m and m.group(2):
            targets.add(int(m.group(2), 16))
    out, cur = [], []
    for a, ins in seq:
        if cur and a in targets:
            out.append(cur)
            cur = []
        cur.append((a, ins))
        if "BRA" in ins or _op(ins) == "EXIT":
            out.append(cur)
            cur = []
    if cur:
        out.append(cur)
    return out


def repeats(bl, min_times=4, max_len=8):
    """[(start index, blocks a repeat, times, instructions and MUFU a
    repeat)] of the maximal runs of a block sequence that recurs at least
    min_times in a row (blocks compared by instruction and MUFU counts),
    the shortest period first, not overlapping."""
    sig = [(b["instructions"], b["mufu"]) for b in bl]
    out, i = [], 0
    while i < len(sig):
        best = None
        for p in range(1, max_len + 1):
            t = 1
            while sig[i + t * p: i + (t + 1) * p] == sig[i: i + p]:
                t += 1
            if t >= min_times and sum(x[0] for x in sig[i: i + p]) > p:
                best = (p, t)
                break
        if best is None:
            i += 1
            continue
        p, t = best
        out.append({"first_block": hex(int(bl[i]["start"], 16)), "blocks": p, "times": t,
                    "instructions": sum(x[0] for x in sig[i: i + p]),
                    "mufu": sum(x[1] for x in sig[i: i + p])})
        i += p * t
    return out


def summary(name, instrs, labels, with_blocks=False):
    last_exit = max((i for i, (_, s) in enumerate(instrs) if s.split()[0:1] == ["EXIT"]
                     or " EXIT" in s), default=len(instrs) - 1)
    body = instrs[: last_exit + 1]
    found = []
    for s, e, seq in loops(body, labels):
        loop = {"start": hex(s), "end": hex(e), **count(seq)}
        if with_blocks:
            loop["blocks"] = [{"start": hex(b[0][0]), **count(b, loads=True)}
                              for b in blocks(seq, labels)]
            loop["repeats"] = repeats(loop["blocks"])
        found.append(loop)
    return {"function": name, **count(body), "loops": found}


def main(path, needle, with_blocks=False):
    text = open(path).read()
    for name, (instrs, labels) in functions(text).items():
        if needle in name:
            print(json.dumps(summary(name, instrs, labels, with_blocks)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], "--blocks" in sys.argv[3:])
