"""TPC-H data generator (vectorized, deterministic).

The reference obtains data from the official dbgen tool
(reference: tools/generate/tpch.sh — downloads and builds tpch-dbgen); this
environment has no network, so we generate spec-shaped data in numpy: same
schemas, key structures, value distributions, and the comment/name patterns
the 22 queries select on (Q9 p_name colors, Q13 o_comment 'special requests',
Q16 s_comment 'Customer Complaints', mktsegments, ship modes, priorities).
Row counts follow the spec scaling rules. Correctness of the engine is
established by running the same generated data through sqlite3 as a
differential oracle (tests/test_tpch.py), not by comparing to dbgen output.
"""

from __future__ import annotations

import numpy as np

from ..sql.types import Type
from ..storage.column import Column
from ..storage.table import TableStorage

EPOCH = np.datetime64("1970-01-01", "D")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
NOUNS = (
    "packages requests accounts deposits foxes ideas theodolites pinto beans "
    "instructions dependencies excuses platelets asymptotes courts dolphins "
    "multipliers sauternes warthogs frets dinos attainments somas braids "
    "frays warhorses dugouts notornis epitaphs pearls tithes waters orbits "
    "gifts sheaves depths sentiments decoys realms pains grouches escapades"
).split()
VERBS = (
    "sleep wake are cajole haggle nag use boost affix detect integrate "
    "maintain nod was lose sublate solve thrash promise engage hinder print "
    "x-ray breach eat"
).split()
ADJECTIVES = (
    "furious sly careful blithe quick fluffy slow quiet ruthless thin close "
    "dogged daring brave stealthy permanent enticing idle busy regular final "
    "ironic even bold silent special pending unusual express"
).split()


def _dates(rng, n, lo="1992-01-01", hi="1998-08-02"):
    a = (np.datetime64(lo) - EPOCH).astype(np.int64)
    b = (np.datetime64(hi) - EPOCH).astype(np.int64)
    return rng.integers(a, b + 1, n).astype(np.int32)


def _comment_pool(rng, size, maxlen, specials=()):
    """Pool of distinct comment strings; `specials` = (pattern, fraction)."""
    w1 = rng.choice(ADJECTIVES, size)
    w2 = rng.choice(NOUNS, size)
    w3 = rng.choice(VERBS, size)
    w4 = rng.choice(ADJECTIVES, size)
    w5 = rng.choice(NOUNS, size)
    pool = np.array(
        [f"{a} {b} {c} {d} {e}"[:maxlen] for a, b, c, d, e in zip(w1, w2, w3, w4, w5)],
        dtype=object,
    )
    for pattern, frac in specials:
        k = max(int(size * frac), 1)
        idx = rng.choice(size, k, replace=False)
        for i in idx:
            filler = str(pool[i])
            s = (filler[: max(0, maxlen - len(pattern) - 2)] + " " + pattern)[:maxlen]
            pool[i] = s.strip()
    return pool


def _strcol(values: np.ndarray, t: Type) -> Column:
    dictionary, codes = np.unique(values, return_inverse=True)
    return Column(t, codes.astype(np.int32), None, dictionary.astype(object))


def _dec(v_cents: np.ndarray, p: int, s: int) -> Column:
    return Column(Type.decimal(p, s), v_cents.astype(np.int64), None)


def _int(v) -> Column:
    return Column(Type.int_(), np.asarray(v, np.int32), None)


def _date(v) -> Column:
    return Column(Type.date(), np.asarray(v, np.int32), None)


def generate(sf: float = 0.01, seed: int = 19920601) -> dict[str, TableStorage]:
    rng = np.random.default_rng(seed)
    out: dict[str, TableStorage] = {}

    # first column of each table is its clustered sort key (like dbgen's
    # output files: lineitem comes clustered by l_orderkey, orders by
    # o_orderkey, ...); declare it so the executor can use monotone
    # windowed gathers for FK probes. Verified at build time.
    def table(name, cols: dict[str, Column]):
        names = list(cols.keys())
        columns = list(cols.values())
        types = [c.type for c in columns]
        t = TableStorage(name, names, types, columns, len(columns[0].data))
        d = np.asarray(columns[0].data)
        if len(d) == 0 or (np.issubdtype(d.dtype, np.number)
                           and bool(np.all(d[1:] >= d[:-1]))):
            t.sorted_cols = (names[0],)
        out[name] = t

    # ---- region / nation ------------------------------------------------
    table("region", {
        "r_regionkey": _int(np.arange(5)),
        "r_name": _strcol(np.array(REGIONS, object), Type.char(25)),
        "r_comment": _strcol(_comment_pool(rng, 5, 152), Type.string()),
    })
    table("nation", {
        "n_nationkey": _int(np.arange(25)),
        "n_name": _strcol(np.array([n for n, _ in NATIONS], object), Type.char(25)),
        "n_regionkey": _int(np.array([r for _, r in NATIONS])),
        "n_comment": _strcol(_comment_pool(rng, 25, 152), Type.string()),
    })

    # ---- supplier -------------------------------------------------------
    n_supp = max(int(10_000 * sf), 10)
    skey = np.arange(1, n_supp + 1)
    s_nation = rng.integers(0, 25, n_supp)
    s_comment = rng.choice(
        _comment_pool(rng, max(n_supp // 2, 10), 101,
                      specials=[("Customer Complaints", 0.01),
                                ("Customer Recommends", 0.01)]),
        n_supp,
    )
    table("supplier", {
        "s_suppkey": _int(skey),
        "s_name": _strcol(np.array([f"Supplier#{k:09d}" for k in skey], object), Type.char(25)),
        "s_address": _strcol(np.array([f"addr sup {k % 9973}" for k in skey], object), Type.string()),
        "s_nationkey": _int(s_nation),
        "s_phone": _strcol(np.array(
            [f"{10 + nk}-{rng.integers(100, 999)}-{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
             for nk in s_nation], object), Type.char(15)),
        "s_acctbal": _dec(rng.integers(-99999, 999999, n_supp), 15, 2),
        "s_comment": _strcol(s_comment.astype(object), Type.string()),
    })

    # ---- part -----------------------------------------------------------
    n_part = max(int(200_000 * sf), 40)
    pkey = np.arange(1, n_part + 1)
    c5 = rng.choice(COLORS, (n_part, 5))
    p_name = np.array([" ".join(row) for row in c5], object)
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    p_type = np.array(
        [f"{rng.choice(TYPE_S1)} {rng.choice(TYPE_S2)} {rng.choice(TYPE_S3)}"
         for _ in range(n_part)], object)
    p_cont = np.array(
        [f"{rng.choice(CONT_S1)} {rng.choice(CONT_S2)}" for _ in range(n_part)], object)
    p_retail = (90000 + (pkey % 200001) / 10 + 100 * (pkey % 1000)).astype(np.int64) // 1 + 0
    p_retail = (90000 + ((pkey // 10) % 20001) + 100 * (pkey % 1000)).astype(np.int64)
    table("part", {
        "p_partkey": _int(pkey),
        "p_name": _strcol(p_name, Type.string()),
        "p_mfgr": _strcol(np.array([f"Manufacturer#{m}" for m in mfgr], object), Type.char(25)),
        "p_brand": _strcol(np.array([f"Brand#{b}" for b in brand], object), Type.char(10)),
        "p_type": _strcol(p_type, Type.string()),
        "p_size": _int(rng.integers(1, 51, n_part)),
        "p_container": _strcol(p_cont, Type.char(10)),
        "p_retailprice": _dec(p_retail, 15, 2),
        "p_comment": _strcol(rng.choice(_comment_pool(rng, max(n_part // 4, 10), 23), n_part).astype(object), Type.string()),
    })

    # ---- partsupp -------------------------------------------------------
    ps_part = np.repeat(pkey, 4)
    i = np.tile(np.arange(4), n_part)
    # 4 distinct suppliers per part (spec: partsupp PK is (partkey, suppkey));
    # stride n_supp//4 keeps i*stride < n_supp, so no wraparound collisions
    stride = max(1, n_supp // 4)
    ps_supp = ((ps_part - 1 + i * stride) % n_supp) + 1
    n_ps = len(ps_part)
    table("partsupp", {
        "ps_partkey": _int(ps_part),
        "ps_suppkey": _int(ps_supp),
        "ps_availqty": _int(rng.integers(1, 10000, n_ps)),
        "ps_supplycost": _dec(rng.integers(100, 100001, n_ps), 15, 2),
        "ps_comment": _strcol(rng.choice(_comment_pool(rng, max(n_ps // 16, 10), 79), n_ps).astype(object), Type.string()),
    })

    # ---- customer -------------------------------------------------------
    n_cust = max(int(150_000 * sf), 30)
    ckey = np.arange(1, n_cust + 1)
    c_nation = rng.integers(0, 25, n_cust)
    table("customer", {
        "c_custkey": _int(ckey),
        "c_name": _strcol(np.array([f"Customer#{k:09d}" for k in ckey], object), Type.string()),
        "c_address": _strcol(np.array([f"addr cst {k % 7919}" for k in ckey], object), Type.string()),
        "c_nationkey": _int(c_nation),
        "c_phone": _strcol(np.array(
            [f"{10 + nk}-{100 + (k * 7) % 900}-{100 + (k * 13) % 900}-{1000 + (k * 31) % 9000}"
             for nk, k in zip(c_nation, ckey)], object), Type.char(15)),
        "c_acctbal": _dec(rng.integers(-99999, 999999, n_cust), 15, 2),
        "c_mktsegment": _strcol(rng.choice(SEGMENTS, n_cust).astype(object), Type.char(10)),
        "c_comment": _strcol(rng.choice(
            _comment_pool(rng, max(n_cust // 4, 10), 117,
                          specials=[("special requests", 0.02)]), n_cust).astype(object), Type.string()),
    })

    # ---- orders ---------------------------------------------------------
    n_ord = max(int(1_500_000 * sf), 150)
    okey = np.arange(1, n_ord + 1) * 4 - 3  # sparse keys like dbgen
    # customers with custkey % 3 == 0 place no orders (spec 4.2.3)
    cust_pool = ckey[ckey % 3 != 0]
    o_cust = rng.choice(cust_pool, n_ord)
    o_date = _dates(rng, n_ord, "1992-01-01", "1998-08-02")
    table("orders", {
        "o_orderkey": _int(okey),
        "o_custkey": _int(o_cust),
        "o_orderstatus": _strcol(np.full(n_ord, "O", object), Type.char(1)),  # fixed below
        "o_totalprice": _dec(np.zeros(n_ord, np.int64), 15, 2),  # fixed below
        "o_orderdate": _date(o_date),
        "o_orderpriority": _strcol(rng.choice(PRIORITIES, n_ord).astype(object), Type.char(15)),
        "o_clerk": _strcol(np.array([f"Clerk#{1 + k % max(int(1000 * sf), 10):09d}" for k in range(n_ord)], object), Type.char(15)),
        "o_shippriority": _int(np.zeros(n_ord)),
        "o_comment": _strcol(rng.choice(
            _comment_pool(rng, max(n_ord // 8, 10), 79,
                          specials=[("special packages requests", 0.01)]), n_ord).astype(object), Type.string()),
    })

    # ---- lineitem -------------------------------------------------------
    n_lines_per = rng.integers(1, 8, n_ord)
    l_order = np.repeat(okey, n_lines_per)
    l_odate = np.repeat(o_date, n_lines_per)
    n_li = len(l_order)
    l_linenum = np.concatenate([np.arange(1, k + 1) for k in n_lines_per])
    l_part = rng.integers(1, n_part + 1, n_li)
    # supplier selected among the part's 4 partsupp suppliers — MUST use the
    # same formula as the partsupp build above, or the (l_partkey,
    # l_suppkey) pair never exists in partsupp and every partsupp x lineitem
    # join (TPC-H q9, q20) is vacuously empty (spec 4.2.3: dbgen derives
    # both from one PART_SUPP_BRIDGE; caught in round 5 when q9@SF1
    # returned 0 rows and sqlite3 agreed — the differential suite cannot
    # see a bug both sides share)
    j = rng.integers(0, 4, n_li)
    stride_l = max(1, n_supp // 4)
    l_supp = ((l_part - 1 + j * stride_l) % n_supp) + 1
    qty = rng.integers(1, 51, n_li)
    retail = p_retail[l_part - 1]
    extprice = qty * retail
    disc = rng.integers(0, 11, n_li)  # scale-2 cents: 0.00..0.10
    tax = rng.integers(0, 9, n_li)
    shipdate = l_odate + rng.integers(1, 122, n_li)
    commitdate = l_odate + rng.integers(30, 91, n_li)
    receiptdate = shipdate + rng.integers(1, 31, n_li)
    current = (np.datetime64("1995-06-17") - EPOCH).astype(np.int64)
    returnflag = np.where(
        receiptdate <= current,
        rng.choice(np.array(["R", "A"], object), n_li),
        np.array("N", object),
    )
    linestatus = np.where(shipdate > current, np.array("O", object), np.array("F", object))
    table("lineitem", {
        "l_orderkey": _int(l_order),
        "l_partkey": _int(l_part),
        "l_suppkey": _int(l_supp),
        "l_linenumber": _int(l_linenum),
        "l_quantity": _dec(qty.astype(np.int64) * 100, 15, 2),
        "l_extendedprice": _dec(extprice, 15, 2),
        "l_discount": _dec(disc.astype(np.int64), 15, 2),
        "l_tax": _dec(tax.astype(np.int64), 15, 2),
        "l_returnflag": _strcol(returnflag, Type.char(1)),
        "l_linestatus": _strcol(linestatus, Type.char(1)),
        "l_shipdate": _date(shipdate),
        "l_commitdate": _date(commitdate),
        "l_receiptdate": _date(receiptdate),
        "l_shipinstruct": _strcol(rng.choice(INSTRUCTS, n_li).astype(object), Type.char(25)),
        "l_shipmode": _strcol(rng.choice(MODES, n_li).astype(object), Type.char(10)),
        "l_comment": _strcol(rng.choice(_comment_pool(rng, 4096, 44), n_li).astype(object), Type.string()),
    })

    # fix orders.o_totalprice / o_orderstatus from lineitems (spec 4.2.3)
    charge = (extprice * (100 - disc) * (100 + tax)) // 10000
    totals = np.zeros(n_ord, np.int64)
    np.add.at(totals, np.repeat(np.arange(n_ord), n_lines_per), charge)
    out["orders"].columns[3] = _dec(totals, 15, 2)
    all_f = np.zeros(n_ord, np.bool_)
    any_f = np.zeros(n_ord, np.bool_)
    oidx = np.repeat(np.arange(n_ord), n_lines_per)
    f = linestatus == "F"
    np.add.at(any_f, oidx, f)
    cnt_f = np.zeros(n_ord, np.int64)
    np.add.at(cnt_f, oidx, f.astype(np.int64))
    status = np.where(cnt_f == n_lines_per, np.array("F", object),
                      np.where(cnt_f == 0, np.array("O", object), np.array("P", object)))
    out["orders"].columns[2] = _strcol(status, Type.char(1))
    return out


def _cache_dir(sf: float, seed: int) -> str:
    import os

    root = os.environ.get(
        "LINGODB_TPCH_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".cache"),
    )
    # _v2: lineitem (l_partkey, l_suppkey) pairs drawn from partsupp's
    # actual bridge (pre-v2 caches have vacuously-empty q9/q20 joins)
    return os.path.join(root, f"tpch_sf{sf:g}_seed{seed}_v2")


def generate_cached(sf: float, seed: int) -> dict[str, TableStorage]:
    """generate(), memoized on disk as Arrow IPC (dictionary-encoded strings,
    scaled-int decimals: loading is pure bulk reads)."""
    import json
    import os

    d = _cache_dir(sf, seed)
    meta_path = os.path.join(d, "schema.json")
    if os.path.exists(meta_path):
        meta = json.load(open(meta_path))
        out = {}
        for name, sch in meta.items():
            from ..catalog.catalog import type_from_json

            names = [c[0] for c in sch]
            types = [type_from_json(c[1]) for c in sch]
            out[name] = TableStorage.load(name, d, names, types)
        return out
    tables = generate(sf, seed)
    if os.environ.get("LINGODB_TPCH_CACHE", "").upper() != "OFF":
        try:
            os.makedirs(d, exist_ok=True)
            meta = {}
            for name, t in tables.items():
                t.save(d)
                from ..catalog.catalog import type_to_json

                meta[name] = [[n, type_to_json(ty)] for n, ty in
                              zip(t.column_names, t.column_types)]
            json.dump(meta, open(meta_path, "w"))
        except Exception:
            pass
    return tables


# TPC-H spec primary keys (spec 1.4.2; the reference ships them in its DB
# metadata — they feed FD-based optimizations like ReduceGroupByKeys and
# groupjoin detection)
PRIMARY_KEYS = {
    "part": ["p_partkey"],
    "supplier": ["s_suppkey"],
    "partsupp": ["ps_partkey", "ps_suppkey"],
    "customer": ["c_custkey"],
    "orders": ["o_orderkey"],
    "lineitem": ["l_orderkey", "l_linenumber"],
    "nation": ["n_nationkey"],
    "region": ["r_regionkey"],
}


def load_into(session, sf: float = 0.01, seed: int = 19920601):
    """Install generated TPC-H tables into a session's catalog."""
    from ..catalog.catalog import TableEntry

    return install(session, generate_cached(sf, seed))


def install(session, tables: dict[str, TableStorage]):
    """Install already generated TPC-H tables into a session's catalog (two
    sessions may share one generated set: storage is read-only to queries)."""
    from ..catalog.catalog import TableEntry

    for name, storage in tables.items():
        if not storage.sorted_cols:  # disk-cache loads lose the declaration
            key = PRIMARY_KEYS.get(name, [None])[0]
            if key is not None:
                d = np.asarray(storage.column(key).data)
                if np.issubdtype(d.dtype, np.number) and bool(
                        np.all(d[1:] >= d[:-1])):
                    storage.sorted_cols = (key,)
        session.catalog.tables[name] = TableEntry(
            name, storage.column_names, storage.column_types,
            PRIMARY_KEYS.get(name, []), storage,
        )
    return tables


def to_sqlite(conn, tables: dict[str, TableStorage]):
    """Load the same data into a sqlite3 connection (differential oracle).
    Decimals become floats, dates become ISO strings."""
    from ..sql.types import K

    cur = conn.cursor()
    for name, t in tables.items():
        cols = ", ".join(t.column_names)
        cur.execute(f"CREATE TABLE {name} ({cols})")
        arrays = []
        for c in t.columns:
            if c.dictionary is not None:
                arrays.append(c.dictionary[c.data])
            elif c.type.kind == K.DECIMAL:
                arrays.append(c.data / (10.0**c.type.s))
            elif c.type.kind == K.DATE:
                arrays.append((EPOCH + c.data.astype("timedelta64[D]")).astype(str))
            else:
                arrays.append(c.data)
        rows = list(zip(*[a.tolist() for a in arrays]))
        ph = ", ".join("?" * len(t.column_names))
        cur.executemany(f"INSERT INTO {name} VALUES ({ph})", rows)
    conn.commit()
