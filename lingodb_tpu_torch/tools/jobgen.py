"""JOB (Join Order Benchmark, IMDB schema) data generator.

The reference loads real IMDB dumps for its JOB conformance suite
(reference: tools/generate/job.sh + resources/sql/job/initialize.sql). This
module needs no download and generates IMDB-schema-shaped data instead: the 21
tables from the DDL, fixed dimension contents (kind_type, company_type,
role_type, link_type, comp_cast_type, info_type) matching the values the 113
queries filter on, and entity tables whose strings embed the LIKE patterns
the queries probe ('%Freddy%', 'USA:% 200%', '(voice)', '[us]', ...).
Correctness is established differentially vs sqlite3 (tools/sqlite_oracle.py)."""

from __future__ import annotations

import numpy as np

from ..sql.types import Type
from ..storage.column import Column
from ..storage.table import TableStorage

KIND_TYPES = ["movie", "tv series", "tv movie", "video movie", "video game",
              "episode", "tv mini series"]
COMPANY_TYPES = ["production companies", "distributors",
                 "special effects companies", "miscellaneous companies"]
ROLE_TYPES = ["actor", "actress", "producer", "writer", "cinematographer",
              "composer", "costume designer", "director", "editor",
              "miscellaneous crew", "production designer", "guest"]
LINK_TYPES = ["sequel", "follows", "followed by", "remake of", "remade as",
              "references", "referenced in", "spoofs", "spoofed in",
              "features", "featured in", "spin off from", "spin off",
              "version of", "similar to", "edited into", "edited from",
              "alternate language version of"]
CCT_KINDS = ["cast", "crew", "complete", "complete+verified"]
INFO_TYPES = ["top 250 rank", "bottom 10 rank", "budget", "countries",
              "genres", "rating", "release dates", "votes", "height",
              "mini biography", "trivia", "languages", "runtimes", "color info",
              "taglines", "quotes", "goofs", "soundtrack", "certificates",
              "locations", "tech info", "sound mix", "gross", "opening weekend"]
GENRES = ["Drama", "Horror", "Western", "Family", "Action", "Sci-Fi",
          "Thriller", "Crime", "War", "Comedy", "Romance", "Adventure",
          "Animation", "Documentary", "Mystery", "Musical"]
COUNTRIES_INFO = ["USA", "Germany", "Sweden", "Norway", "Denmark", "Japan",
                  "France", "UK", "Canada", "Italy", "American", "German",
                  "Swedish", "Norwegian", "Danish"]
COUNTRY_CODES = ["[us]", "[de]", "[jp]", "[nl]", "[ru]", "[pl]", "[fr]",
                 "[sm]", "[gb]", "[it]", "[se]", "[ca]"]
KEYWORDS = ["10,000-mile-club", "alienation", "based-on-comic",
            "based-on-novel", "blood", "character-name-in-title", "claw",
            "computer-animated-movie", "computer-animation", "death",
            "dignity", "female-nudity", "fight", "gore", "hand-to-hand-combat",
            "hero", "hospital", "laser", "loner", "magnet", "martial-arts",
            "marvel-cinematic-universe", "marvel-comics", "murder",
            "murder-in-title", "nerd", "revenge", "second-part", "sequel",
            "the-sequel", "superhero", "tv-special", "violence", "web",
            "love", "friendship", "betrayal", "family-relationships"]
TITLE_SEEDS = ["Shrek 2", "Vampire Diary", "Freddy vs Jason",
               "Kung Fu Panda", "Kung Fu Panda 2", "Money Talks",
               "Murder Mystery", "Mord im Orient", "Iron Man", "Iron Man 2",
               "The Dark Knight", "Champion", "Loser Takes All",
               "Marvelous Adventures", "Dark Waters", "Golden Years"]
NAME_SEEDS = ["Stark, Tony", "Iron Man", "Queen", "Bert Williams",
              "Angelina Wells", "Angel Martinez", "Tim Burton", "Tony Stark",
              "Downey Robert", "Ang Lee", "Young Tim", "Bertram Moore",
              "Yolanda Price", "Mankiewicz Joseph"]
CHAR_SEEDS = ["Tony Stark", "Iron Man", "Queen", "Sherlock Holmes",
              "James Bond", "The Joker", "Angel", "Man in Black"]
COMPANY_SEEDS = ["DreamWorks Animation", "YouTube", "Lionsgate Films",
                 "20th Century Fox", "Twentieth Century Fox Film Corporation",
                 "Metro-Goldwyn-Mayer Pictures", "Warner Bros",
                 "Universal Pictures", "Polygram Filmed Entertainment",
                 "Studio Ghibli", "Channel 4 Television Corporation"]
MC_NOTES = ["(2006) (USA) (TV)", "(2007) (USA) (theatrical)", "(200?) (VHS)",
            "(1994) (Japan) (TV)", "(co-production)", "(presents)",
            "(as Metro-Goldwyn-Mayer Pictures)", "(as Blue Sky)",
            "(2008) (worldwide) (Blu-ray)", "(France) (theatrical)",
            "(USA) (VHS)", "(200x) (internet)", ""]
CI_NOTES = ["(voice)", "(voice: Japanese version)", "(voice: English version)",
            "(voice) (uncredited)", "(producer)", "(executive producer)",
            "(writer)", "(head writer)", "(written by)", "(story)",
            "(story editor)", "(uncredited)", ""]
FIRST = ["Alan", "Bert", "Carla", "Dana", "Erik", "Fay", "Gus", "Hilda",
         "Ivan", "Jo", "Karl", "Lena", "Max", "Nora", "Otto", "Pia", "Quinn",
         "Rosa", "Sven", "Tim", "Ulla", "Vera", "Walt", "Xena", "Yuri", "Zoe",
         "Angel", "Tony", "Angelica"]
LAST = ["Anders", "Berg", "Cruz", "Dietrich", "Eastman", "Falk", "Gray",
        "Holm", "Ito", "Jansen", "Koch", "Lund", "Meyer", "North", "Olsen",
        "Park", "Quist", "Ruiz", "Stark", "Toledo", "Unger", "Vogel",
        "Wells", "Xu", "Young", "Zimmer"]
WORDS = ["Dark", "Golden", "Silent", "Broken", "Hidden", "Lost", "Final",
         "Eternal", "Rising", "Fallen", "Secret", "Burning", "Frozen",
         "Sacred", "Savage", "Gentle", "Murder", "Money", "Vampire",
         "Panda", "Man", "Kung", "Fu", "Freddy", "Jason"]
NOUNS = ["Night", "River", "Crown", "Empire", "Garden", "Harbor", "Island",
         "Journey", "Kingdom", "Legend", "Mountain", "Ocean", "Palace",
         "Quest", "Road", "Storm", "Tower", "Valley", "Winter", "Shadow"]


def _pcode(name: str) -> str:
    """Soundex-ish phonetic code (A-Z + digits, <=5 chars)."""
    s = "".join(c for c in name.upper() if c.isalpha())
    if not s:
        return ""
    out = s[0]
    m = {"B": "1", "F": "1", "P": "1", "V": "1", "C": "2", "G": "2", "J": "2",
         "K": "2", "Q": "2", "S": "2", "X": "2", "Z": "2", "D": "3", "T": "3",
         "L": "4", "M": "5", "N": "5", "R": "6"}
    for c in s[1:]:
        d = m.get(c, "")
        if d and (len(out) < 2 or out[-1] != d):
            out += d
        if len(out) >= 5:
            break
    return out


def _str(values, t=None) -> Column:
    arr = np.asarray(values, dtype=object)
    dictionary, codes = np.unique(arr, return_inverse=True)
    return Column(t or Type.string(True), codes.astype(np.int32), None,
                  dictionary.astype(object))


def _int(v) -> Column:
    return Column(Type.int_(True), np.asarray(v, np.int32), None)


def _int_null(v, valid) -> Column:
    return Column(Type.int_(True), np.asarray(v, np.int32), np.asarray(valid, bool))


def _md5ish(keys) -> np.ndarray:
    return np.array([f"{int(k) * 2654435761 % (1 << 63):032x}"[:32] for k in keys], object)


def generate(sf: float = 0.01, seed: int = 19330127) -> dict[str, TableStorage]:
    rng = np.random.default_rng(seed)
    out: dict[str, TableStorage] = {}

    def table(name, cols):
        names = list(cols.keys())
        columns = list(cols.values())
        out[name] = TableStorage(name, names, types := [c.type for c in columns],
                                 columns, len(columns[0].data))

    def dim(name, idcol, strcol, values):
        ids = np.arange(1, len(values) + 1)
        table(name, {idcol: _int(ids), strcol: _str(np.array(values, object))})

    dim("kind_type", "id", "kind", KIND_TYPES)
    dim("company_type", "id", "kind", COMPANY_TYPES)
    dim("role_type", "id", "role", ROLE_TYPES)
    dim("link_type", "id", "link", LINK_TYPES)
    dim("comp_cast_type", "id", "kind", CCT_KINDS)
    dim("info_type", "id", "info", INFO_TYPES)
    it_id = {v: i + 1 for i, v in enumerate(INFO_TYPES)}

    # ---- title ----------------------------------------------------------
    n_title = max(int(250_000 * sf), 400)
    tid = np.arange(1, n_title + 1)
    base_titles = np.array(
        [f"{WORDS[k % len(WORDS)]} {NOUNS[(k * 7) % len(NOUNS)]}"
         + (f" {k % 9 + 2}" if k % 11 == 0 else "") for k in tid], object)
    seeds = np.array(TITLE_SEEDS, object)
    seed_pos = rng.choice(n_title, size=min(len(seeds) * 8, n_title), replace=False)
    base_titles[seed_pos] = seeds[np.arange(len(seed_pos)) % len(seeds)]
    kind_id = rng.choice([1, 1, 1, 1, 2, 3, 4, 5, 6], n_title)
    prod_year = np.where(
        rng.random(n_title) < 0.75,
        rng.integers(1990, 2013, n_title), rng.integers(1880, 1990, n_title))
    year_valid = rng.random(n_title) >= 0.05
    table("title", {
        "id": _int(tid),
        "title": _str(base_titles),
        "imdb_index": _str(np.where(rng.random(n_title) < 0.9, "", "I"), Type.string(True)),
        "kind_id": _int(kind_id),
        "production_year": _int_null(np.where(year_valid, prod_year, 0), year_valid),
        "imdb_id": _int(tid),
        "phonetic_code": _str(np.array([_pcode(t) for t in base_titles], object), Type.string(True)),
        "episode_of_id": _int_null(np.where(kind_id == 6, rng.integers(1, n_title + 1, n_title), 0), kind_id == 6),
        "season_nr": _int_null(np.where(kind_id == 6, rng.integers(1, 12, n_title), 0), kind_id == 6),
        "episode_nr": _int_null(np.where(kind_id == 6, rng.integers(1, 25, n_title), 0), kind_id == 6),
        "series_years": _str(np.where(kind_id == 2, "1998-2004", ""), Type.string(True)),
        "md5sum": _str(_md5ish(tid), Type.string(True)),
    })

    # ---- name / char_name / company_name --------------------------------
    n_name = max(int(150_000 * sf), 300)
    nid = np.arange(1, n_name + 1)
    names = np.array(
        [f"{LAST[k % len(LAST)]}, {FIRST[(k * 3) % len(FIRST)]}" for k in nid], object)
    nseeds = np.array(NAME_SEEDS, object)
    pos = rng.choice(n_name, size=min(len(nseeds) * 6, n_name), replace=False)
    names[pos] = nseeds[np.arange(len(pos)) % len(nseeds)]
    gender = rng.choice(["m", "f", ""], n_name, p=[0.55, 0.4, 0.05])
    table("name", {
        "id": _int(nid),
        "name": _str(names),
        "imdb_index": _str(np.where(rng.random(n_name) < 0.95, "", "I"), Type.string(True)),
        "imdb_id": _int(nid),
        "gender": _str(gender, Type.string(True)),
        "name_pcode_cf": _str(np.array([_pcode(n) for n in names], object), Type.string(True)),
        "name_pcode_nf": _str(np.array([_pcode(n.split(",")[-1]) for n in names], object), Type.string(True)),
        "surname_pcode": _str(np.array([_pcode(n.split(",")[0]) for n in names], object), Type.string(True)),
        "md5sum": _str(_md5ish(nid), Type.string(True)),
    })
    table("aka_name", {
        "id": _int(nid[: n_name // 3]),
        "person_id": _int(rng.integers(1, n_name + 1, n_name // 3)),
        "name": _str(names[rng.integers(0, n_name, n_name // 3)]),
        "imdb_index": _str(np.full(n_name // 3, "", object), Type.string(True)),
        "name_pcode_cf": _str(np.full(n_name // 3, "A452", object), Type.string(True)),
        "name_pcode_nf": _str(np.full(n_name // 3, "A452", object), Type.string(True)),
        "surname_pcode": _str(np.full(n_name // 3, "B62", object), Type.string(True)),
        "md5sum": _str(_md5ish(nid[: n_name // 3]), Type.string(True)),
    })

    n_char = max(int(80_000 * sf), 200)
    chid = np.arange(1, n_char + 1)
    chnames = np.array(
        [f"{FIRST[(k * 5) % len(FIRST)]} {LAST[k % len(LAST)]}" for k in chid], object)
    cseeds = np.array(CHAR_SEEDS, object)
    pos = rng.choice(n_char, size=min(len(cseeds) * 6, n_char), replace=False)
    chnames[pos] = cseeds[np.arange(len(pos)) % len(cseeds)]
    table("char_name", {
        "id": _int(chid),
        "name": _str(chnames),
        "imdb_index": _str(np.full(n_char, "", object), Type.string(True)),
        "imdb_id": _int(chid),
        "name_pcode_nf": _str(np.array([_pcode(c) for c in chnames], object), Type.string(True)),
        "surname_pcode": _str(np.array([_pcode(c.split()[-1]) for c in chnames], object), Type.string(True)),
        "md5sum": _str(_md5ish(chid), Type.string(True)),
    })

    n_cn = max(int(20_000 * sf), 120)
    cnid = np.arange(1, n_cn + 1)
    cnames = np.array(
        [f"{NOUNS[k % len(NOUNS)]} {['Pictures', 'Films', 'Studios', 'Entertainment', 'Productions'][k % 5]}"
         for k in cnid], object)
    cseeds = np.array(COMPANY_SEEDS, object)
    pos = rng.choice(n_cn, size=min(len(cseeds) * 4, n_cn), replace=False)
    cnames[pos] = cseeds[np.arange(len(pos)) % len(cseeds)]
    codes = rng.choice(COUNTRY_CODES, n_cn, p=[0.45, 0.1, 0.08, 0.04, 0.04,
                                               0.04, 0.05, 0.02, 0.08, 0.04,
                                               0.03, 0.03])
    table("company_name", {
        "id": _int(cnid),
        "name": _str(cnames),
        "country_code": _str(codes, Type.string(True)),
        "imdb_id": _int(cnid),
        "name_pcode_nf": _str(np.array([_pcode(c) for c in cnames], object), Type.string(True)),
        "name_pcode_sf": _str(np.array([_pcode(c) for c in cnames], object), Type.string(True)),
        "md5sum": _str(_md5ish(cnid), Type.string(True)),
    })

    dim("keyword", "id", "keyword", KEYWORDS)
    out["keyword"].column_names.append("phonetic_code")
    out["keyword"].column_types.append(Type.string(True))
    out["keyword"].columns.append(
        _str(np.array([_pcode(k) for k in KEYWORDS], object), Type.string(True)))

    n_aka_t = n_title // 4
    table("aka_title", {
        "id": _int(np.arange(1, n_aka_t + 1)),
        "movie_id": _int(rng.integers(1, n_title + 1, n_aka_t)),
        "title": _str(base_titles[rng.integers(0, n_title, n_aka_t)]),
        "imdb_index": _str(np.full(n_aka_t, "", object), Type.string(True)),
        "kind_id": _int(rng.choice([1, 2, 3], n_aka_t)),
        "production_year": _int(rng.integers(1950, 2012, n_aka_t)),
        "phonetic_code": _str(np.full(n_aka_t, "T52", object), Type.string(True)),
        "episode_of_id": _int_null(np.zeros(n_aka_t), np.zeros(n_aka_t, bool)),
        "season_nr": _int_null(np.zeros(n_aka_t), np.zeros(n_aka_t, bool)),
        "episode_nr": _int_null(np.zeros(n_aka_t), np.zeros(n_aka_t, bool)),
        "note": _str(rng.choice(["(USA)", "(worldwide)", ""], n_aka_t), Type.string(True)),
        "md5sum": _str(_md5ish(np.arange(1, n_aka_t + 1)), Type.string(True)),
    })

    # ---- cast_info ------------------------------------------------------
    n_ci = max(int(1_400_000 * sf), 3000)
    ciid = np.arange(1, n_ci + 1)
    role = rng.choice(np.arange(1, 13), n_ci,
                      p=np.array([30, 20, 8, 8, 3, 3, 2, 6, 4, 12, 2, 2]) / 100)
    has_char = np.isin(role, [1, 2]) & (rng.random(n_ci) < 0.8)
    table("cast_info", {
        "id": _int(ciid),
        "person_id": _int(rng.integers(1, n_name + 1, n_ci)),
        "movie_id": _int(rng.integers(1, n_title + 1, n_ci)),
        "person_role_id": _int_null(np.where(has_char, rng.integers(1, n_char + 1, n_ci), 0), has_char),
        "note": _str(rng.choice(CI_NOTES, n_ci), Type.string(True)),
        "nr_order": _int_null(rng.integers(1, 40, n_ci), rng.random(n_ci) < 0.7),
        "role_id": _int(role),
    })

    # ---- movie_companies ------------------------------------------------
    n_mc = max(int(600_000 * sf), 1500)
    table("movie_companies", {
        "id": _int(np.arange(1, n_mc + 1)),
        "movie_id": _int(rng.integers(1, n_title + 1, n_mc)),
        "company_id": _int(rng.integers(1, n_cn + 1, n_mc)),
        "company_type_id": _int(rng.choice([1, 1, 2, 2, 2, 3, 4], n_mc)),
        "note": _str(rng.choice(MC_NOTES, n_mc), Type.string(True)),
    })

    # ---- movie_info -----------------------------------------------------
    blocks = []
    n_genre = max(int(300_000 * sf), 800)
    blocks.append((np.full(n_genre, it_id["genres"]),
                   rng.choice(GENRES, n_genre),
                   np.full(n_genre, "", object)))
    n_ctry = max(int(200_000 * sf), 600)
    blocks.append((np.full(n_ctry, it_id["countries"]),
                   rng.choice(COUNTRIES_INFO, n_ctry),
                   np.full(n_ctry, "", object)))
    n_rel = max(int(250_000 * sf), 700)
    rel_c = rng.choice(["USA", "Japan", "Germany", "France"], n_rel, p=[0.5, 0.2, 0.2, 0.1])
    rel_y = rng.integers(1995, 2013, n_rel)
    rel = np.array([f"{c}: {m} {y}" for c, m, y in
                    zip(rel_c, rng.integers(1, 13, n_rel), rel_y)], object)
    rel = np.char.replace(rel.astype(str), ": ", ":").astype(object)
    blocks.append((np.full(n_rel, it_id["release dates"]), rel,
                   np.full(n_rel, "", object)))
    n_bud = max(int(50_000 * sf), 200)
    blocks.append((np.full(n_bud, it_id["budget"]),
                   np.array([f"${v}0,000" for v in rng.integers(10, 2000, n_bud)], object),
                   np.full(n_bud, "", object)))
    mi_it = np.concatenate([b[0] for b in blocks])
    mi_info = np.concatenate([np.asarray(b[1], object) for b in blocks])
    mi_note = np.concatenate([b[2] for b in blocks])
    n_mi = len(mi_it)
    note_pool = np.array(["", "", "", "(internet survey)", "approx."], object)
    mi_note = np.where(mi_note == "", note_pool[rng.integers(0, 5, n_mi)], mi_note)
    table("movie_info", {
        "id": _int(np.arange(1, n_mi + 1)),
        "movie_id": _int(rng.integers(1, n_title + 1, n_mi)),
        "info_type_id": _int(mi_it),
        "info": _str(mi_info),
        "note": _str(mi_note, Type.string(True)),
    })

    # ---- movie_info_idx -------------------------------------------------
    n_rat = max(int(100_000 * sf), 400)
    rat_it = rng.choice([it_id["rating"], it_id["votes"],
                         it_id["top 250 rank"], it_id["bottom 10 rank"]],
                        n_rat, p=[0.45, 0.45, 0.05, 0.05])
    rat_info = np.where(
        rat_it == it_id["rating"],
        np.array([f"{v / 10:.1f}" for v in rng.integers(10, 100, n_rat)], object),
        np.where(rat_it == it_id["votes"],
                 np.array([str(v) for v in rng.integers(100, 500000, n_rat)], object),
                 np.array([str(v) for v in rng.integers(1, 251, n_rat)], object)))
    table("movie_info_idx", {
        "id": _int(np.arange(1, n_rat + 1)),
        "movie_id": _int(rng.integers(1, n_title + 1, n_rat)),
        "info_type_id": _int(rat_it),
        "info": _str(rat_info),
        "note": _str(np.full(n_rat, "", object), Type.string(True)),
    })

    # ---- movie_keyword / movie_link / complete_cast / person_info -------
    n_mk = max(int(450_000 * sf), 1200)
    table("movie_keyword", {
        "id": _int(np.arange(1, n_mk + 1)),
        "movie_id": _int(rng.integers(1, n_title + 1, n_mk)),
        "keyword_id": _int(rng.integers(1, len(KEYWORDS) + 1, n_mk)),
    })
    n_ml = max(int(30_000 * sf), 150)
    table("movie_link", {
        "id": _int(np.arange(1, n_ml + 1)),
        "movie_id": _int(rng.integers(1, n_title + 1, n_ml)),
        "linked_movie_id": _int(rng.integers(1, n_title + 1, n_ml)),
        "link_type_id": _int(rng.integers(1, len(LINK_TYPES) + 1, n_ml)),
    })
    n_cc = max(int(13_000 * sf), 100)
    table("complete_cast", {
        "id": _int(np.arange(1, n_cc + 1)),
        "movie_id": _int(rng.integers(1, n_title + 1, n_cc)),
        "subject_id": _int(rng.choice([1, 2], n_cc)),
        "status_id": _int(rng.choice([3, 4], n_cc)),
    })
    n_pi = max(int(300_000 * sf), 600)
    pi_it = rng.choice([it_id["mini biography"], it_id["height"], it_id["trivia"]],
                       n_pi, p=[0.5, 0.2, 0.3])
    pi_info = np.where(
        pi_it == it_id["height"],
        np.array([f"{v / 100:.2f} m" for v in rng.integers(150, 205, n_pi)], object),
        np.array([f"Biography text number {k % 499}" for k in range(n_pi)], object))
    table("person_info", {
        "id": _int(np.arange(1, n_pi + 1)),
        "person_id": _int(rng.integers(1, n_name + 1, n_pi)),
        "info_type_id": _int(pi_it),
        "info": _str(pi_info),
        "note": _str(rng.choice(["Volker Boehm", "", "", ""], n_pi), Type.string(True)),
    })
    return out


def load_into(session, sf: float = 0.01, seed: int = 19330127):
    from ..catalog.catalog import TableEntry

    tables = generate(sf, seed)
    for name, storage in tables.items():
        session.catalog.tables[name] = TableEntry(
            name, storage.column_names, storage.column_types, [], storage)
    return tables


def to_sqlite(conn, tables: dict[str, TableStorage]):
    from .tpcdsgen import to_sqlite as _ts

    _ts(conn, tables)
