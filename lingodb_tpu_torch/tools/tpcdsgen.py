"""TPC-DS data generator (schema-driven, vectorized, deterministic).

The reference obtains TPC-DS data from the official dsdgen tool (its CI
downloads it; resources/sql/tpcds/initialize.sql COPYs the .dat files).
Like tpchgen.py, this module needs no download and generates spec-shaped
data instead: the 24-table schema is parsed from the reference's initialize.sql DDL,
the dimension tables carry the exact value domains the 103 queries filter on
(d_year/d_moy/d_month_seq calendar arithmetic, i_category/i_class hierarchy,
cd_* demographic cross product, state/county geography, Y/N flags), and the
fact tables follow the spec's key structure (returns reference sales by
(item_sk, ticket/order_number), price columns satisfy the ext_* = qty*unit
identities). Correctness of the engine is established by running the same
generated data through sqlite3 as a differential oracle (tools/sqlite_oracle.py).
The tables are bit-equal to the JAX package's generator's for the same sf and
seed (tests/test_torch_tools.py).
"""

from __future__ import annotations

import numpy as np

from ..sql.types import K, Type
from ..storage.column import Column
from ..storage.table import TableStorage

EPOCH = np.datetime64("1970-01-01", "D")

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
CLASSES = {
    "Books": ["arts", "business", "computers", "cooking", "entertainments",
              "fiction", "history", "home repair", "mystery", "parenting",
              "reference", "romance", "science", "self-help", "sports", "travel"],
    "Children": ["infants", "newborn", "school-uniforms", "toddlers"],
    "Electronics": ["audio", "automotive", "camcorders", "cameras", "disk drives",
                    "dvd/vcr players", "karoke", "memory", "monitors",
                    "musical", "personal", "portable", "scanners", "stereo",
                    "televisions", "wireless"],
    "Home": ["accent", "bathroom", "bedding", "blinds/shades", "curtains/drapes",
             "decor", "flatware", "furniture", "glassware", "kids", "lighting",
             "mattresses", "paint", "rugs", "tables", "wallpaper"],
    "Jewelry": ["birdal", "bracelets", "costume", "custom", "diamonds",
                "earings", "estate", "gold", "jewelry boxes", "loose stones",
                "mens watch", "pendants", "rings", "semi-precious",
                "womens watch"],
    "Men": ["accessories", "pants", "shirts", "sports-apparel"],
    "Music": ["classical", "country", "pop", "rock"],
    "Shoes": ["athletic", "kids", "mens", "womens"],
    "Sports": ["archery", "athletic shoes", "baseball", "basketball", "camping",
               "fishing", "fitness", "football", "golf", "guns", "hockey",
               "optics", "outdoor", "pools", "sailing", "tennis"],
    "Women": ["dresses", "fragrances", "maternity", "swimwear"],
}
STATES = ["AK", "AL", "AR", "AZ", "CA", "CO", "CT", "DE", "FL", "GA", "HI",
          "IA", "ID", "IL", "IN", "KS", "KY", "LA", "MA", "MD", "ME", "MI",
          "MN", "MO", "MS", "MT", "NC", "ND", "NE", "NH", "NJ", "NM", "NV",
          "NY", "OH", "OK", "OR", "PA", "RI", "SC", "SD", "TN", "TX", "UT",
          "VA", "VT", "WA", "WI", "WV", "WY"]
# stores cluster in a few states like dsdgen; cover the states queries name
STORE_STATES = ["TN", "TN", "TN", "SD", "SD", "AL", "GA", "CA", "WA", "NC",
                "MN", "FL", "IN", "MI", "OH", "TX"]
COUNTIES = ["Ziebach County", "Walker County", "Williamson County",
            "Bronx County", "Orange County", "Barrow County",
            "Fairfield County", "Franklin Parish", "Luce County",
            "Richland County", "Furnas County", "Maverick County",
            "San Miguel County", "Mobile County", "Huron County"]
CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Pleasant Hill",
          "Centerville", "Liberty", "Salem", "Bethel", "Clinton", "Marion",
          "Union", "Springfield", "Oakland", "Georgetown", "Riverside",
          "Greenfield", "Oakdale", "Glendale", "Lakeview"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
MARITAL = ["M", "S", "D", "W", "U"]
CREDIT = ["Low Risk", "Good", "High Risk", "Unknown"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
                 "Unknown"]
SHIFTS = ["first", "second", "third"]
MEALS = ["breakfast", "lunch", "dinner", ""]
SM_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"]
SM_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
               "ZOUROS", "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN",
               "BOXBUNDLES", "CARGO", "DIAMOND", "RUPEKSA", "GERMA", "HARMSTORF",
               "GREAT EASTERN"]
STORE_NAMES = ["ought", "able", "pri", "ese", "anti", "cally", "ation", "eing",
               "bar", "n st", "ought ought", "able ought"]
COLORS = ["aliceblue", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cream",
          "cyan", "dark", "dim", "dodger", "firebrick", "floral", "forest",
          "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
          "honeydew", "hot", "indian", "ivory", "khaki", "lace", "lavender",
          "lawn", "lemon", "light", "lime", "linen", "magenta", "maroon",
          "medium", "metallic", "midnight", "misty", "moccasin", "navajo",
          "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
          "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
          "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
          "sky", "slate", "smoke", "snow", "spring", "steel", "thistle",
          "tomato", "turquoise", "violet", "wheat", "white", "yellow"]
UNITS = ["Unknown", "Each", "Oz", "Pound", "Pallet", "Gross", "Case", "Dozen",
         "Box", "Bunch", "Bundle", "Carton", "Cup", "Dram", "Gram", "Lb",
         "N/A", "Ounce", "Tbl", "Ton", "Tsp"]
SIZES = ["petite", "small", "medium", "large", "extra large", "economy", "N/A"]
FIRST_NAMES = ["James", "Mary", "John", "Patricia", "Robert", "Jennifer",
               "Michael", "Linda", "William", "Elizabeth", "David", "Barbara",
               "Richard", "Susan", "Joseph", "Jessica", "Thomas", "Sarah",
               "Charles", "Karen", "Daniel", "Nancy", "Matthew", "Lisa",
               "Anthony", "Betty", "Jose", "Anna", "Jacob", "Ruth"]
LAST_NAMES = ["Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
              "Miller", "Davis", "Rodriguez", "Martinez", "Hernandez", "Lopez",
              "Gonzalez", "Wilson", "Anderson", "Thomas", "Taylor", "Moore",
              "Jackson", "Martin", "Lee", "Perez", "Thompson", "White",
              "Harris", "Sanchez", "Clark", "Ramirez", "Lewis", "Robinson"]
COUNTRIES = ["United States"]
SALUTATIONS = ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"]
WEB_SITE_CLASSES = ["Unknown", "mail", "phone", "chat", "internal"]
REASONS = ["Package was damaged", "Stopped working", "Did not fit",
           "Found a better price in a store", "Not the product that was ordred",
           "Parts missing", "Does not work with a product that I have",
           "Gift exchange", "Did not like the color", "Did not like the model",
           "No service location in my area", "Duplicate purchase",
           "Its is a boring color", "Lost my job", "unknown"]

# first/last date_sk of the calendar; spec uses julian day numbers
DATE_LO = np.datetime64("1990-01-01", "D")
DATE_HI = np.datetime64("2003-12-31", "D")
JULIAN_BASE = 2415021  # spec: d_date_sk of 1900-01-01 region; we keep the
#                         convention that 1998-01-01 lands at 2450815 like dsdgen


def _sk_of_date(d):
    return (2450815 + (np.asarray(d).astype("datetime64[D]")
                       - np.datetime64("1998-01-01", "D")).astype(np.int64))


def _str(values, t=None) -> Column:
    arr = np.asarray(values, dtype=object)
    dictionary, codes = np.unique(arr, return_inverse=True)
    return Column(t or Type.string(True), codes.astype(np.int32), None,
                  dictionary.astype(object))


def _int(v, nulls=None) -> Column:
    return Column(Type.int_(True), np.asarray(v, np.int32), nulls)


def _dec(cents, p=7, s=2, nulls=None) -> Column:
    return Column(Type.decimal(p, s, True), np.asarray(cents, np.int64), nulls)


def _ids(prefix: str, keys: np.ndarray, width=16) -> np.ndarray:
    return np.array([f"{prefix}{k:0{width - len(prefix)}d}" for k in keys],
                    dtype=object)


class _Gen:
    def __init__(self, sf: float, seed: int):
        self.rng = np.random.default_rng(seed)
        self.sf = sf
        self.tables: dict[str, dict[str, Column]] = {}

    def nullify(self, col: Column, frac=0.04) -> Column:
        n = len(col.data)
        valid = self.rng.random(n) >= frac
        return Column(col.type.as_nullable(), col.data, valid, col.dictionary)

    # ---------------- dimensions ----------------
    def date_dim(self):
        days = np.arange(DATE_LO, DATE_HI + np.timedelta64(1, "D"))
        n = len(days)
        sk = _sk_of_date(days)
        years = days.astype("datetime64[Y]").astype(int) + 1970
        months0 = days.astype("datetime64[M]").astype(int)  # months since 1970
        moy = months0 % 12 + 1
        dom = (days - days.astype("datetime64[M]").astype("datetime64[D]")).astype(int) + 1
        dow = (days.astype("datetime64[D]").view(np.int64) + 4) % 7  # 0=Sunday
        qoy = (moy - 1) // 3 + 1
        week_seq = ((days - DATE_LO).astype(int) + int(dow[0])) // 7 + 1
        month_seq = months0 - (np.datetime64("1900-01", "M").astype(int))
        dnames = np.array(["Sunday", "Monday", "Tuesday", "Wednesday",
                           "Thursday", "Friday", "Saturday"], object)
        self.tables["date_dim"] = {
            "d_date_sk": _int(sk),
            "d_date_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "d_date": Column(Type.date(True), (days - EPOCH).astype(np.int32), None),
            "d_month_seq": _int(month_seq),
            "d_week_seq": _int(week_seq),
            "d_quarter_seq": _int(month_seq // 3),
            "d_year": _int(years),
            "d_dow": _int(dow),
            "d_moy": _int(moy),
            "d_dom": _int(dom),
            "d_qoy": _int(qoy),
            "d_fy_year": _int(years),
            "d_fy_quarter_seq": _int(month_seq // 3),
            "d_fy_week_seq": _int(week_seq),
            "d_day_name": _str(dnames[dow], Type.char(9, True)),
            "d_quarter_name": _str(np.array([f"{y}Q{q}" for y, q in zip(years, qoy)], object), Type.char(6, True)),
            "d_holiday": _str(np.where(self.rng.random(n) < 0.03, "Y", "N"), Type.char(1, True)),
            "d_weekend": _str(np.where((dow == 0) | (dow == 6), "Y", "N"), Type.char(1, True)),
            "d_following_holiday": _str(np.where(self.rng.random(n) < 0.03, "Y", "N"), Type.char(1, True)),
            "d_first_dom": _int(sk - dom + 1),
            "d_last_dom": _int(sk - dom + 28),
            "d_same_day_ly": _int(sk - 365),
            "d_same_day_lq": _int(sk - 91),
            "d_current_day": _str(np.full(n, "N", object), Type.char(1, True)),
            "d_current_week": _str(np.full(n, "N", object), Type.char(1, True)),
            "d_current_month": _str(np.full(n, "N", object), Type.char(1, True)),
            "d_current_quarter": _str(np.full(n, "N", object), Type.char(1, True)),
            "d_current_year": _str(np.full(n, "N", object), Type.char(1, True)),
        }
        self.date_sks = sk
        self.date_years = years

    def time_dim(self):
        secs = np.arange(86400)
        hour = secs // 3600
        minute = (secs % 3600) // 60
        shift = np.where(hour < 8, "third", np.where(hour < 16, "first", "second"))
        meal = np.where((hour >= 6) & (hour <= 8), "breakfast",
               np.where((hour >= 11) & (hour <= 13), "lunch",
               np.where((hour >= 17) & (hour <= 19), "dinner", "")))
        self.tables["time_dim"] = {
            "t_time_sk": _int(secs),
            "t_time_id": _str(_ids("AAAAAAAA", secs), Type.char(16, True)),
            "t_time": _int(secs),
            "t_hour": _int(hour),
            "t_minute": _int(minute),
            "t_second": _int(secs % 60),
            "t_am_pm": _str(np.where(hour < 12, "AM", "PM"), Type.char(2, True)),
            "t_shift": _str(shift, Type.char(20, True)),
            "t_sub_shift": _str(shift, Type.char(20, True)),
            "t_meal_time": _str(meal, Type.char(20, True)),
        }

    def item(self, n):
        rng = self.rng
        sk = np.arange(1, n + 1)
        cat_idx = rng.integers(0, len(CATEGORIES), n)
        cats = np.array(CATEGORIES, object)[cat_idx]
        classes = np.array([rng.choice(CLASSES[c]) for c in cats], object)
        class_id = rng.integers(1, 17, n)
        brand_id = (cat_idx + 1) * 1000000 + class_id * 10000 + rng.integers(1, 11, n)
        manufact_id = rng.integers(1, 1001, n)
        price_c = rng.integers(99, 30000, n)
        wholesale_c = (price_c * rng.integers(30, 90, n)) // 100
        self.tables["item"] = {
            "i_item_sk": _int(sk),
            "i_item_id": _str(_ids("AAAAAAAA", 1 + (sk - 1) // 2), Type.char(16, True)),
            "i_rec_start_date": Column(Type.date(True), np.full(n, int((np.datetime64("1997-10-27") - EPOCH).astype(int)), np.int32), None),
            "i_rec_end_date": Column(Type.date(True), np.zeros(n, np.int32), np.zeros(n, bool)),
            "i_item_desc": self.nullify(_str(np.array([f"desc of item {k % 997} variety {k % 89}" for k in sk], object))),
            "i_current_price": self.nullify(_dec(price_c)),
            "i_wholesale_cost": self.nullify(_dec(wholesale_c)),
            "i_brand_id": self.nullify(_int(brand_id)),
            "i_brand": self.nullify(_str(np.array([f"brand#{b % 100}" for b in brand_id], object), Type.char(50, True))),
            "i_class_id": self.nullify(_int(class_id)),
            "i_class": self.nullify(_str(classes, Type.char(50, True))),
            "i_category_id": self.nullify(_int(cat_idx + 1)),
            "i_category": self.nullify(_str(cats, Type.char(50, True), ), 0.01),
            "i_manufact_id": self.nullify(_int(manufact_id)),
            "i_manufact": self.nullify(_str(np.array([f"manufact#{m}" for m in manufact_id % 200], object), Type.char(50, True))),
            "i_size": self.nullify(_str(rng.choice(SIZES, n), Type.char(20, True))),
            "i_formulation": self.nullify(_str(np.array([f"form{k % 53}" for k in sk], object), Type.char(20, True))),
            "i_color": self.nullify(_str(rng.choice(COLORS, n), Type.char(20, True))),
            "i_units": self.nullify(_str(rng.choice(UNITS, n), Type.char(10, True))),
            "i_container": self.nullify(_str(np.full(n, "Unknown", object), Type.char(10, True))),
            "i_manager_id": self.nullify(_int(rng.integers(1, 101, n))),
            "i_product_name": _str(np.array([f"product {STORE_NAMES[k % 12]}{STORE_NAMES[(k // 12) % 12]}" for k in sk], object), Type.char(50, True)),
        }
        self.n_item = n

    def geography(self, n):
        """customer_address"""
        rng = self.rng
        sk = np.arange(1, n + 1)
        self.tables["customer_address"] = {
            "ca_address_sk": _int(sk),
            "ca_address_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "ca_street_number": self.nullify(_str(np.array([str(k % 1000 + 1) for k in sk], object), Type.char(10, True))),
            "ca_street_name": self.nullify(_str(np.array([f"{CITIES[k % 20]} {COUNTIES[k % 15].split()[0]}" for k in sk], object))),
            "ca_street_type": self.nullify(_str(rng.choice(["Street", "Ave", "Blvd", "Ct", "Dr", "Ln", "Pkwy", "Way"], n), Type.char(15, True))),
            "ca_suite_number": self.nullify(_str(np.array([f"Suite {k % 100}" for k in sk], object), Type.char(10, True))),
            "ca_city": self.nullify(_str(rng.choice(CITIES, n))),
            "ca_county": self.nullify(_str(rng.choice(COUNTIES, n))),
            "ca_state": self.nullify(_str(rng.choice(STATES, n), Type.char(2, True))),
            "ca_zip": self.nullify(_str(np.array([f"{z:05d}" for z in rng.integers(10000, 99999, n)], object), Type.char(10, True))),
            "ca_country": self.nullify(_str(np.full(n, "United States", object)), 0.01),
            "ca_gmt_offset": self.nullify(_dec(rng.choice([-500, -600, -700, -800], n), 5, 2)),
            "ca_location_type": self.nullify(_str(rng.choice(["apartment", "condo", "single family"], n), Type.char(20, True))),
        }
        self.n_addr = n

    def demographics(self):
        # cross product like the spec (subsampled grid keeps row count modest)
        g = np.array(["M", "F"], object)
        ms = np.array(MARITAL, object)
        es = np.array(EDUCATION, object)
        pe = np.arange(500, 10001, 500)
        cr = np.array(CREDIT, object)
        dep = np.arange(0, 7)
        combos = np.stack(np.meshgrid(
            np.arange(2), np.arange(5), np.arange(7), np.arange(len(pe)),
            np.arange(4), dep, dep, indexing="ij"), axis=-1).reshape(-1, 7)
        n = len(combos)
        sk = np.arange(1, n + 1)
        self.tables["customer_demographics"] = {
            "cd_demo_sk": _int(sk),
            "cd_gender": _str(g[combos[:, 0]], Type.char(1, True)),
            "cd_marital_status": _str(ms[combos[:, 1]], Type.char(1, True)),
            "cd_education_status": _str(es[combos[:, 2]], Type.char(20, True)),
            "cd_purchase_estimate": _int(pe[combos[:, 3]]),
            "cd_credit_rating": _str(cr[combos[:, 4]], Type.char(10, True)),
            "cd_dep_count": _int(combos[:, 5]),
            "cd_dep_employed_count": _int(combos[:, 6]),
            "cd_dep_college_count": _int(combos[:, 6]),
        }
        self.n_cdemo = n

        ib = np.arange(1, 21)
        self.tables["income_band"] = {
            "ib_income_band_sk": _int(ib),
            "ib_lower_bound": _int((ib - 1) * 10000),
            "ib_upper_bound": _int(ib * 10000),
        }
        hd = np.arange(1, 7201)
        self.tables["household_demographics"] = {
            "hd_demo_sk": _int(hd),
            "hd_income_band_sk": _int((hd - 1) % 20 + 1),
            "hd_buy_potential": _str(np.array(BUY_POTENTIAL, object)[(hd - 1) % 6], Type.char(15, True)),
            "hd_dep_count": _int((hd - 1) % 10),
            "hd_vehicle_count": _int((hd - 1) % 6),
        }
        self.n_hdemo = 7200

    def customer(self, n):
        rng = self.rng
        sk = np.arange(1, n + 1)
        bd_year = rng.integers(1924, 1993, n)
        first_date = rng.choice(self.date_sks[(self.date_years >= 1990) & (self.date_years <= 2002)], n)
        self.tables["customer"] = {
            "c_customer_sk": _int(sk),
            "c_customer_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "c_current_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, n))),
            "c_current_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, n))),
            "c_current_addr_sk": _int(rng.integers(1, self.n_addr + 1, n)),
            "c_first_shipto_date_sk": self.nullify(_int(first_date + 30)),
            "c_first_sales_date_sk": self.nullify(_int(first_date)),
            "c_salutation": self.nullify(_str(rng.choice(SALUTATIONS, n), Type.char(10, True))),
            "c_first_name": self.nullify(_str(rng.choice(FIRST_NAMES, n), Type.char(20, True))),
            "c_last_name": self.nullify(_str(rng.choice(LAST_NAMES, n), Type.char(30, True))),
            "c_preferred_cust_flag": self.nullify(_str(rng.choice(["Y", "N"], n), Type.char(1, True))),
            "c_birth_day": self.nullify(_int(rng.integers(1, 29, n))),
            "c_birth_month": self.nullify(_int(rng.integers(1, 13, n))),
            "c_birth_year": self.nullify(_int(bd_year)),
            "c_birth_country": self.nullify(_str(rng.choice(["UNITED STATES", "CANADA", "GERMANY", "JAPAN", "MEXICO", "FRANCE"], n), Type.string(True))),
            "c_login": self.nullify(_str(np.array([f"user{k}" for k in sk], object), Type.char(13, True))),
            "c_email_address": self.nullify(_str(np.array([f"c{k}@example.com" for k in sk], object), Type.char(50, True))),
            "c_last_review_date_sk": self.nullify(_int(first_date + 60)),
        }
        self.n_cust = n

    def small_dims(self, n_store, n_wh, n_web, n_cc, n_wp, n_cp, n_promo):
        rng = self.rng

        def base(prefix, n, extra):
            sk = np.arange(1, n + 1)
            cols = {
                f"{prefix}_{'store' if prefix == 's' else 'x'}_sk": _int(sk),
            }
            return sk, cols

        sk = np.arange(1, n_store + 1)
        st = np.array(STORE_STATES * (n_store // len(STORE_STATES) + 1), object)[:n_store]
        self.tables["store"] = {
            "s_store_sk": _int(sk),
            "s_store_id": _str(_ids("AAAAAAAA", 1 + (sk - 1) // 2), Type.char(16, True)),
            "s_rec_start_date": Column(Type.date(True), np.full(n_store, int((np.datetime64("1997-03-13") - EPOCH).astype(int)), np.int32), None),
            "s_rec_end_date": Column(Type.date(True), np.zeros(n_store, np.int32), np.zeros(n_store, bool)),
            "s_closed_date_sk": self.nullify(_int(rng.choice(self.date_sks, n_store)), 0.7),
            "s_store_name": _str(np.array(STORE_NAMES, object)[(sk - 1) % len(STORE_NAMES)], Type.string(True)),
            "s_number_employees": _int(rng.integers(200, 301, n_store)),
            "s_floor_space": _int(rng.integers(5000000, 10000000, n_store)),
            "s_hours": _str(rng.choice(["8AM-4PM", "8AM-12AM", "8AM-8AM"], n_store), Type.char(20, True)),
            "s_manager": _str(rng.choice(FIRST_NAMES, n_store), Type.string(True)),
            "s_market_id": _int(rng.integers(1, 11, n_store)),
            "s_geography_class": _str(np.full(n_store, "Unknown", object), Type.string(True)),
            "s_market_desc": _str(np.array([f"market desc {k % 17}" for k in sk], object), Type.string(True)),
            "s_market_manager": _str(rng.choice(FIRST_NAMES, n_store), Type.string(True)),
            "s_division_id": _int(np.ones(n_store, int)),
            "s_division_name": _str(np.full(n_store, "Unknown", object), Type.string(True)),
            "s_company_id": _int(np.ones(n_store, int)),
            "s_company_name": _str(np.full(n_store, "Unknown", object), Type.string(True)),
            "s_street_number": _str(np.array([str(100 + k) for k in sk], object), Type.string(True)),
            "s_street_name": _str(rng.choice(CITIES, n_store), Type.string(True)),
            "s_street_type": _str(np.full(n_store, "Street", object), Type.char(15, True)),
            "s_suite_number": _str(np.array([f"Suite {k}" for k in sk], object), Type.char(10, True)),
            "s_city": _str(rng.choice(CITIES[:6], n_store), Type.string(True)),
            "s_county": _str(rng.choice(COUNTIES[:5], n_store), Type.string(True)),
            "s_state": _str(st, Type.char(2, True)),
            "s_zip": _str(np.array([f"{z:05d}" for z in rng.integers(10000, 99999, n_store)], object), Type.char(10, True)),
            "s_country": _str(np.full(n_store, "United States", object), Type.string(True)),
            "s_gmt_offset": _dec(rng.choice([-500, -600], n_store), 5, 2),
            "s_tax_precentage": _dec(rng.integers(0, 12, n_store), 5, 2),
        }
        self.n_store = n_store

        sk = np.arange(1, n_wh + 1)
        self.tables["warehouse"] = {
            "w_warehouse_sk": _int(sk),
            "w_warehouse_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "w_warehouse_name": _str(np.array([f"Warehouse {k}" for k in sk], object)),
            "w_warehouse_sq_ft": self.nullify(_int(rng.integers(50000, 1000000, n_wh))),
            "w_street_number": _str(np.array([str(k * 7 % 1000) for k in sk], object), Type.char(10, True)),
            "w_street_name": _str(rng.choice(CITIES, n_wh)),
            "w_street_type": _str(np.full(n_wh, "Street", object), Type.char(15, True)),
            "w_suite_number": _str(np.array([f"Suite {k}" for k in sk], object), Type.char(10, True)),
            "w_city": _str(rng.choice(CITIES[:6], n_wh)),
            "w_county": _str(rng.choice(COUNTIES[:5], n_wh)),
            "w_state": _str(rng.choice(STORE_STATES, n_wh), Type.char(2, True)),
            "w_zip": _str(np.array([f"{z:05d}" for z in rng.integers(10000, 99999, n_wh)], object), Type.char(10, True)),
            "w_country": _str(np.full(n_wh, "United States", object)),
            "w_gmt_offset": _dec(rng.choice([-500, -600], n_wh), 5, 2),
        }
        self.n_wh = n_wh

        sm = np.arange(1, 21)
        self.tables["ship_mode"] = {
            "sm_ship_mode_sk": _int(sm),
            "sm_ship_mode_id": _str(_ids("AAAAAAAA", sm), Type.char(16, True)),
            "sm_type": _str(np.array(SM_TYPES, object)[(sm - 1) % 6], Type.char(30, True)),
            "sm_code": _str(np.array(["AIR", "SURFACE", "SEA"], object)[(sm - 1) % 3], Type.char(10, True)),
            "sm_carrier": _str(np.array(SM_CARRIERS, object)[sm - 1], Type.char(20, True)),
            "sm_contract": _str(np.array([f"contract{k}" for k in sm], object), Type.char(20, True)),
        }

        rs = np.arange(1, len(REASONS) + 1)
        self.tables["reason"] = {
            "r_reason_sk": _int(rs),
            "r_reason_id": _str(_ids("AAAAAAAA", rs), Type.char(16, True)),
            "r_reason_desc": _str(np.array(REASONS, object), Type.char(100, True)),
        }
        self.n_reason = len(REASONS)

        sk = np.arange(1, n_web + 1)
        self.tables["web_site"] = {
            "web_site_sk": _int(sk),
            "web_site_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "web_rec_start_date": Column(Type.date(True), np.full(n_web, int((np.datetime64("1997-08-16") - EPOCH).astype(int)), np.int32), None),
            "web_rec_end_date": Column(Type.date(True), np.zeros(n_web, np.int32), np.zeros(n_web, bool)),
            "web_name": _str(np.array([f"site_{k % 4}" for k in sk], object)),
            "web_open_date_sk": _int(rng.choice(self.date_sks[:3000], n_web)),
            "web_close_date_sk": self.nullify(_int(rng.choice(self.date_sks, n_web)), 0.7),
            "web_class": _str(np.full(n_web, "Unknown", object)),
            "web_manager": _str(rng.choice(FIRST_NAMES, n_web)),
            "web_mkt_id": _int(rng.integers(1, 7, n_web)),
            "web_mkt_class": _str(np.array([f"mkt class {k % 9}" for k in sk], object)),
            "web_mkt_desc": _str(np.array([f"mkt desc {k % 9}" for k in sk], object)),
            "web_market_manager": _str(rng.choice(FIRST_NAMES, n_web)),
            "web_company_id": _int((sk - 1) % 6 + 1),
            "web_company_name": _str(np.array(["pri", "able", "ought", "ese", "anti", "cally"], object)[(sk - 1) % 6], Type.char(50, True)),
            "web_street_number": _str(np.array([str(k) for k in sk], object), Type.char(10, True)),
            "web_street_name": _str(rng.choice(CITIES, n_web)),
            "web_street_type": _str(np.full(n_web, "Street", object), Type.char(15, True)),
            "web_suite_number": _str(np.array([f"Suite {k}" for k in sk], object), Type.char(10, True)),
            "web_city": _str(rng.choice(CITIES[:6], n_web)),
            "web_county": _str(rng.choice(COUNTIES[:5], n_web)),
            "web_state": _str(rng.choice(STORE_STATES, n_web), Type.char(2, True)),
            "web_zip": _str(np.array([f"{z:05d}" for z in rng.integers(10000, 99999, n_web)], object), Type.char(10, True)),
            "web_country": _str(np.full(n_web, "United States", object)),
            "web_gmt_offset": _dec(rng.choice([-500, -600], n_web), 5, 2),
            "web_tax_percentage": _dec(rng.integers(0, 12, n_web), 5, 2),
        }
        self.n_web = n_web

        sk = np.arange(1, n_cc + 1)
        self.tables["call_center"] = {
            "cc_call_center_sk": _int(sk),
            "cc_call_center_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "cc_rec_start_date": Column(Type.date(True), np.full(n_cc, int((np.datetime64("1998-01-01") - EPOCH).astype(int)), np.int32), None),
            "cc_rec_end_date": Column(Type.date(True), np.zeros(n_cc, np.int32), np.zeros(n_cc, bool)),
            "cc_closed_date_sk": self.nullify(_int(rng.choice(self.date_sks, n_cc)), 0.9),
            "cc_open_date_sk": _int(rng.choice(self.date_sks[:3000], n_cc)),
            "cc_name": _str(np.array([f"call center {k}" for k in sk], object), Type.string(True)),
            "cc_class": _str(rng.choice(["small", "medium", "large"], n_cc), Type.string(True)),
            "cc_employees": _int(rng.integers(1, 7, n_cc)),
            "cc_sq_ft": _int(rng.integers(1000, 10000, n_cc)),
            "cc_hours": _str(rng.choice(["8AM-4PM", "8AM-12AM", "8AM-8AM"], n_cc), Type.char(20, True)),
            "cc_manager": _str(rng.choice(FIRST_NAMES, n_cc), Type.string(True)),
            "cc_mkt_id": _int(rng.integers(1, 7, n_cc)),
            "cc_mkt_class": _str(np.array([f"mkt class {k % 9}" for k in sk], object), Type.char(50, True)),
            "cc_mkt_desc": _str(np.array([f"mkt desc {k % 9}" for k in sk], object), Type.string(True)),
            "cc_market_manager": _str(rng.choice(FIRST_NAMES, n_cc), Type.char(40, True)),
            "cc_division": _int((sk - 1) % 6 + 1),
            "cc_division_name": _str(np.array(["pri", "able", "ought", "ese", "anti", "cally"], object)[(sk - 1) % 6], Type.string(True)),
            "cc_company": _int((sk - 1) % 6 + 1),
            "cc_company_name": _str(np.array(["pri", "able", "ought", "ese", "anti", "cally"], object)[(sk - 1) % 6], Type.char(50, True)),
            "cc_street_number": _str(np.array([str(k) for k in sk], object), Type.char(10, True)),
            "cc_street_name": _str(rng.choice(CITIES, n_cc), Type.string(True)),
            "cc_street_type": _str(np.full(n_cc, "Street", object), Type.char(15, True)),
            "cc_suite_number": _str(np.array([f"Suite {k}" for k in sk], object), Type.char(10, True)),
            "cc_city": _str(rng.choice(CITIES[:6], n_cc), Type.string(True)),
            "cc_county": _str(rng.choice(COUNTIES[:5], n_cc), Type.string(True)),
            "cc_state": _str(rng.choice(STORE_STATES, n_cc), Type.char(2, True)),
            "cc_zip": _str(np.array([f"{z:05d}" for z in rng.integers(10000, 99999, n_cc)], object), Type.char(10, True)),
            "cc_country": _str(np.full(n_cc, "United States", object), Type.string(True)),
            "cc_gmt_offset": _dec(rng.choice([-500, -600], n_cc), 5, 2),
            "cc_tax_percentage": _dec(rng.integers(0, 12, n_cc), 5, 2),
        }
        self.n_cc = n_cc

        sk = np.arange(1, n_wp + 1)
        self.tables["web_page"] = {
            "wp_web_page_sk": _int(sk),
            "wp_web_page_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "wp_rec_start_date": Column(Type.date(True), np.full(n_wp, int((np.datetime64("1997-09-03") - EPOCH).astype(int)), np.int32), None),
            "wp_rec_end_date": Column(Type.date(True), np.zeros(n_wp, np.int32), np.zeros(n_wp, bool)),
            "wp_creation_date_sk": _int(rng.choice(self.date_sks[:3000], n_wp)),
            "wp_access_date_sk": _int(rng.choice(self.date_sks, n_wp)),
            "wp_autogen_flag": _str(rng.choice(["Y", "N"], n_wp), Type.char(1, True)),
            "wp_customer_sk": self.nullify(_int(rng.integers(1, 100, n_wp)), 0.5),
            "wp_url": _str(np.full(n_wp, "http://www.foo.com", object), Type.char(100, True)),
            "wp_type": _str(rng.choice(["ad", "bio", "dynamic", "feedback", "general", "order", "protected", "welcome"], n_wp), Type.char(50, True)),
            "wp_char_count": _int(rng.integers(100, 8000, n_wp)),
            "wp_link_count": _int(rng.integers(2, 25, n_wp)),
            "wp_image_count": _int(rng.integers(1, 7, n_wp)),
            "wp_max_ad_count": _int(rng.integers(0, 5, n_wp)),
        }
        self.n_wp = n_wp

        sk = np.arange(1, n_cp + 1)
        self.tables["catalog_page"] = {
            "cp_catalog_page_sk": _int(sk),
            "cp_catalog_page_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "cp_start_date_sk": _int(rng.choice(self.date_sks[:4000], n_cp)),
            "cp_end_date_sk": _int(rng.choice(self.date_sks[4000:], n_cp)),
            "cp_department": _str(np.full(n_cp, "DEPARTMENT", object)),
            "cp_catalog_number": _int((sk - 1) // 100 + 1),
            "cp_catalog_page_number": _int((sk - 1) % 100 + 1),
            "cp_description": _str(np.array([f"catalog page desc {k % 211}" for k in sk], object)),
            "cp_type": _str(rng.choice(["annual", "bi-annual", "quarterly", "monthly"], n_cp)),
        }
        self.n_cp = n_cp

        sk = np.arange(1, n_promo + 1)
        self.tables["promotion"] = {
            "p_promo_sk": _int(sk),
            "p_promo_id": _str(_ids("AAAAAAAA", sk), Type.char(16, True)),
            "p_start_date_sk": self.nullify(_int(rng.choice(self.date_sks, n_promo))),
            "p_end_date_sk": self.nullify(_int(rng.choice(self.date_sks, n_promo))),
            "p_item_sk": self.nullify(_int(rng.integers(1, self.n_item + 1, n_promo))),
            "p_cost": self.nullify(_dec(np.full(n_promo, 100000), 15, 2)),
            "p_response_target": self.nullify(_int(np.ones(n_promo, int))),
            "p_promo_name": self.nullify(_str(rng.choice(["anti", "ought", "able", "pri", "ese", "bar"], n_promo), Type.char(50, True))),
            "p_channel_dmail": self.nullify(_str(rng.choice(["Y", "N"], n_promo), Type.char(1, True))),
            "p_channel_email": self.nullify(_str(np.where(rng.random(n_promo) < 0.9, "N", "Y"), Type.char(1, True))),
            "p_channel_catalog": self.nullify(_str(np.where(rng.random(n_promo) < 0.9, "N", "Y"), Type.char(1, True))),
            "p_channel_tv": self.nullify(_str(np.where(rng.random(n_promo) < 0.9, "N", "Y"), Type.char(1, True))),
            "p_channel_radio": self.nullify(_str(np.where(rng.random(n_promo) < 0.9, "N", "Y"), Type.char(1, True))),
            "p_channel_press": self.nullify(_str(np.where(rng.random(n_promo) < 0.9, "N", "Y"), Type.char(1, True))),
            "p_channel_event": self.nullify(_str(np.where(rng.random(n_promo) < 0.9, "N", "Y"), Type.char(1, True))),
            "p_channel_demo": self.nullify(_str(np.where(rng.random(n_promo) < 0.9, "N", "Y"), Type.char(1, True))),
            "p_channel_details": self.nullify(_str(np.array([f"promo details {k % 101}" for k in sk], object), Type.string(True))),
            "p_purpose": self.nullify(_str(np.full(n_promo, "Unknown", object), Type.char(15, True))),
            "p_discount_active": self.nullify(_str(np.full(n_promo, "N", object), Type.char(1, True))),
        }
        self.n_promo = n_promo

    # ---------------- facts ----------------
    def _sale_dates(self, n):
        """sold-date sks concentrated on 1998-2002 (the years queries hit)."""
        mask = (self.date_years >= 1998) & (self.date_years <= 2002)
        return self.rng.choice(self.date_sks[mask], n)

    def _prices(self, n):
        rng = self.rng
        qty = rng.integers(1, 101, n)
        wholesale = rng.integers(100, 10000, n)  # cents
        list_p = (wholesale * rng.integers(100, 201, n)) // 100
        sales_p = (list_p * rng.integers(0, 101, n)) // 100
        disc = (list_p - sales_p) * qty
        ext_sales = sales_p * qty
        ext_whole = wholesale * qty
        ext_list = list_p * qty
        tax = ext_sales * rng.integers(0, 10, n) // 100
        coupon = np.where(rng.random(n) < 0.1, ext_sales // 10, 0)
        net_paid = ext_sales - coupon
        net_inc_tax = net_paid + tax
        profit = net_paid - ext_whole
        return dict(qty=qty, wholesale=wholesale, list_p=list_p, sales_p=sales_p,
                    disc=disc, ext_sales=ext_sales, ext_whole=ext_whole,
                    ext_list=ext_list, tax=tax, coupon=coupon,
                    net_paid=net_paid, net_inc_tax=net_inc_tax, profit=profit)

    def store_sales(self, n):
        rng = self.rng
        d = self._sale_dates(n)
        p = self._prices(n)
        item = rng.integers(1, self.n_item + 1, n)
        ticket = np.arange(1, n + 1) // 3 + 1  # ~3 lines per ticket
        self.tables["store_sales"] = {
            "ss_sold_date_sk": self.nullify(_int(d)),
            "ss_sold_time_sk": self.nullify(_int(rng.integers(28800, 75600, n))),
            "ss_item_sk": _int(item),
            "ss_customer_sk": self.nullify(_int(rng.integers(1, self.n_cust + 1, n))),
            "ss_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, n))),
            "ss_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, n))),
            "ss_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, n))),
            "ss_store_sk": self.nullify(_int(rng.integers(1, self.n_store + 1, n))),
            "ss_promo_sk": self.nullify(_int(rng.integers(1, self.n_promo + 1, n))),
            "ss_ticket_number": _int(ticket),
            "ss_quantity": self.nullify(_int(p["qty"])),
            "ss_wholesale_cost": self.nullify(_dec(p["wholesale"])),
            "ss_list_price": self.nullify(_dec(p["list_p"])),
            "ss_sales_price": self.nullify(_dec(p["sales_p"])),
            "ss_ext_discount_amt": self.nullify(_dec(p["disc"])),
            "ss_ext_sales_price": self.nullify(_dec(p["ext_sales"])),
            "ss_ext_wholesale_cost": self.nullify(_dec(p["ext_whole"])),
            "ss_ext_list_price": self.nullify(_dec(p["ext_list"])),
            "ss_ext_tax": self.nullify(_dec(p["tax"])),
            "ss_coupon_amt": self.nullify(_dec(p["coupon"])),
            "ss_net_paid": self.nullify(_dec(p["net_paid"])),
            "ss_net_paid_inc_tax": self.nullify(_dec(p["net_inc_tax"])),
            "ss_net_profit": self.nullify(_dec(p["profit"])),
        }
        return d, item, ticket

    def store_returns(self, sold_d, item, ticket, frac=0.1):
        rng = self.rng
        n = len(item)
        idx = np.flatnonzero(rng.random(n) < frac)
        m = len(idx)
        ret_d = sold_d[idx] + rng.integers(1, 60, m)
        amt = rng.integers(100, 10000, m)
        fee = rng.integers(50, 100, m)
        self.tables["store_returns"] = {
            "sr_returned_date_sk": self.nullify(_int(ret_d)),
            "sr_return_time_sk": self.nullify(_int(rng.integers(28800, 75600, m))),
            "sr_item_sk": _int(item[idx]),
            "sr_customer_sk": self.nullify(_int(rng.integers(1, self.n_cust + 1, m))),
            "sr_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, m))),
            "sr_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, m))),
            "sr_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, m))),
            "sr_store_sk": self.nullify(_int(rng.integers(1, self.n_store + 1, m))),
            "sr_reason_sk": self.nullify(_int(rng.integers(1, self.n_reason + 1, m))),
            "sr_ticket_number": _int(ticket[idx]),
            "sr_return_quantity": self.nullify(_int(rng.integers(1, 10, m))),
            "sr_return_amt": self.nullify(_dec(amt)),
            "sr_return_tax": self.nullify(_dec(amt // 20)),
            "sr_return_amt_inc_tax": self.nullify(_dec(amt + amt // 20)),
            "sr_fee": self.nullify(_dec(fee)),
            "sr_return_ship_cost": self.nullify(_dec(amt // 10)),
            "sr_refunded_cash": self.nullify(_dec(amt // 2)),
            "sr_reversed_charge": self.nullify(_dec(amt // 4)),
            "sr_store_credit": self.nullify(_dec(amt // 4)),
            "sr_net_loss": self.nullify(_dec(amt // 3 + fee)),
        }

    def catalog_sales(self, n):
        rng = self.rng
        d = self._sale_dates(n)
        p = self._prices(n)
        item = rng.integers(1, self.n_item + 1, n)
        order = np.arange(1, n + 1) // 4 + 1
        bill_cust = rng.integers(1, self.n_cust + 1, n)
        ship_same = rng.random(n) < 0.85
        ship_cust = np.where(ship_same, bill_cust, rng.integers(1, self.n_cust + 1, n))
        ship_cost = p["ext_whole"] // 10
        self.tables["catalog_sales"] = {
            "cs_sold_date_sk": self.nullify(_int(d)),
            "cs_sold_time_sk": self.nullify(_int(rng.integers(0, 86400, n))),
            "cs_ship_date_sk": self.nullify(_int(d + rng.integers(1, 90, n))),
            "cs_bill_customer_sk": self.nullify(_int(bill_cust)),
            "cs_bill_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, n))),
            "cs_bill_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, n))),
            "cs_bill_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, n))),
            "cs_ship_customer_sk": self.nullify(_int(ship_cust)),
            "cs_ship_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, n))),
            "cs_ship_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, n))),
            "cs_ship_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, n))),
            "cs_call_center_sk": self.nullify(_int(rng.integers(1, self.n_cc + 1, n))),
            "cs_catalog_page_sk": self.nullify(_int(rng.integers(1, self.n_cp + 1, n))),
            "cs_ship_mode_sk": self.nullify(_int(rng.integers(1, 21, n))),
            "cs_warehouse_sk": self.nullify(_int(rng.integers(1, self.n_wh + 1, n))),
            "cs_item_sk": _int(item),
            "cs_promo_sk": self.nullify(_int(rng.integers(1, self.n_promo + 1, n))),
            "cs_order_number": _int(order),
            "cs_quantity": self.nullify(_int(p["qty"])),
            "cs_wholesale_cost": self.nullify(_dec(p["wholesale"])),
            "cs_list_price": self.nullify(_dec(p["list_p"])),
            "cs_sales_price": self.nullify(_dec(p["sales_p"])),
            "cs_ext_discount_amt": self.nullify(_dec(p["disc"])),
            "cs_ext_sales_price": self.nullify(_dec(p["ext_sales"])),
            "cs_ext_wholesale_cost": self.nullify(_dec(p["ext_whole"])),
            "cs_ext_list_price": self.nullify(_dec(p["ext_list"])),
            "cs_ext_tax": self.nullify(_dec(p["tax"])),
            "cs_coupon_amt": self.nullify(_dec(p["coupon"])),
            "cs_ext_ship_cost": self.nullify(_dec(ship_cost)),
            "cs_net_paid": self.nullify(_dec(p["net_paid"])),
            "cs_net_paid_inc_tax": self.nullify(_dec(p["net_inc_tax"])),
            "cs_net_paid_inc_ship": self.nullify(_dec(p["net_paid"] + ship_cost)),
            "cs_net_paid_inc_ship_tax": self.nullify(_dec(p["net_inc_tax"] + ship_cost)),
            "cs_net_profit": _dec(p["profit"]),
        }
        return d, item, order

    def catalog_returns(self, sold_d, item, order, frac=0.1):
        rng = self.rng
        idx = np.flatnonzero(rng.random(len(item)) < frac)
        m = len(idx)
        ret_d = sold_d[idx] + rng.integers(1, 60, m)
        amt = rng.integers(100, 10000, m)
        fee = rng.integers(50, 100, m)
        self.tables["catalog_returns"] = {
            "cr_returned_date_sk": _int(ret_d),
            "cr_returned_time_sk": _int(rng.integers(0, 86400, m)),
            "cr_item_sk": _int(item[idx]),
            "cr_refunded_customer_sk": self.nullify(_int(rng.integers(1, self.n_cust + 1, m))),
            "cr_refunded_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, m))),
            "cr_refunded_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, m))),
            "cr_refunded_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, m))),
            "cr_returning_customer_sk": self.nullify(_int(rng.integers(1, self.n_cust + 1, m))),
            "cr_returning_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, m))),
            "cr_returning_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, m))),
            "cr_returning_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, m))),
            "cr_call_center_sk": self.nullify(_int(rng.integers(1, self.n_cc + 1, m))),
            "cr_catalog_page_sk": self.nullify(_int(rng.integers(1, self.n_cp + 1, m))),
            "cr_ship_mode_sk": self.nullify(_int(rng.integers(1, 21, m))),
            "cr_warehouse_sk": self.nullify(_int(rng.integers(1, self.n_wh + 1, m))),
            "cr_reason_sk": self.nullify(_int(rng.integers(1, self.n_reason + 1, m))),
            "cr_order_number": _int(order[idx]),
            "cr_return_quantity": self.nullify(_int(rng.integers(1, 10, m))),
            "cr_return_amount": self.nullify(_dec(amt)),
            "cr_return_tax": self.nullify(_dec(amt // 20)),
            "cr_return_amt_inc_tax": self.nullify(_dec(amt + amt // 20)),
            "cr_fee": self.nullify(_dec(fee)),
            "cr_return_ship_cost": self.nullify(_dec(amt // 10)),
            "cr_refunded_cash": self.nullify(_dec(amt // 2)),
            "cr_reversed_charge": self.nullify(_dec(amt // 4)),
            "cr_store_credit": self.nullify(_dec(amt // 4)),
            "cr_net_loss": self.nullify(_dec(amt // 3 + fee)),
        }

    def web_sales(self, n):
        rng = self.rng
        d = self._sale_dates(n)
        p = self._prices(n)
        item = rng.integers(1, self.n_item + 1, n)
        order = np.arange(1, n + 1) // 4 + 1
        bill = rng.integers(1, self.n_cust + 1, n)
        ship_cost = p["ext_whole"] // 10
        self.tables["web_sales"] = {
            "ws_sold_date_sk": self.nullify(_int(d)),
            "ws_sold_time_sk": self.nullify(_int(rng.integers(0, 86400, n))),
            "ws_ship_date_sk": self.nullify(_int(d + rng.integers(1, 120, n))),
            "ws_item_sk": _int(item),
            "ws_bill_customer_sk": self.nullify(_int(bill)),
            "ws_bill_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, n))),
            "ws_bill_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, n))),
            "ws_bill_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, n))),
            "ws_ship_customer_sk": self.nullify(_int(np.where(rng.random(n) < 0.85, bill, rng.integers(1, self.n_cust + 1, n)))),
            "ws_ship_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, n))),
            "ws_ship_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, n))),
            "ws_ship_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, n))),
            "ws_web_page_sk": self.nullify(_int(rng.integers(1, self.n_wp + 1, n))),
            "ws_web_site_sk": self.nullify(_int(rng.integers(1, self.n_web + 1, n))),
            "ws_ship_mode_sk": self.nullify(_int(rng.integers(1, 21, n))),
            "ws_warehouse_sk": self.nullify(_int(rng.integers(1, self.n_wh + 1, n))),
            "ws_promo_sk": self.nullify(_int(rng.integers(1, self.n_promo + 1, n))),
            "ws_order_number": _int(order),
            "ws_quantity": self.nullify(_int(p["qty"])),
            "ws_wholesale_cost": self.nullify(_dec(p["wholesale"])),
            "ws_list_price": self.nullify(_dec(p["list_p"])),
            "ws_sales_price": self.nullify(_dec(p["sales_p"])),
            "ws_ext_discount_amt": self.nullify(_dec(p["disc"])),
            "ws_ext_sales_price": self.nullify(_dec(p["ext_sales"])),
            "ws_ext_wholesale_cost": self.nullify(_dec(p["ext_whole"])),
            "ws_ext_list_price": self.nullify(_dec(p["ext_list"])),
            "ws_ext_tax": self.nullify(_dec(p["tax"])),
            "ws_coupon_amt": self.nullify(_dec(p["coupon"])),
            "ws_ext_ship_cost": self.nullify(_dec(ship_cost)),
            "ws_net_paid": self.nullify(_dec(p["net_paid"])),
            "ws_net_paid_inc_tax": self.nullify(_dec(p["net_inc_tax"])),
            "ws_net_paid_inc_ship": self.nullify(_dec(p["net_paid"] + ship_cost)),
            "ws_net_paid_inc_ship_tax": self.nullify(_dec(p["net_inc_tax"] + ship_cost)),
            "ws_net_profit": _dec(p["profit"]),
        }
        return d, item, order

    def web_returns(self, sold_d, item, order, frac=0.1):
        rng = self.rng
        idx = np.flatnonzero(rng.random(len(item)) < frac)
        m = len(idx)
        ret_d = sold_d[idx] + rng.integers(1, 60, m)
        amt = rng.integers(100, 10000, m)
        fee = rng.integers(50, 100, m)
        self.tables["web_returns"] = {
            "wr_returned_date_sk": self.nullify(_int(ret_d)),
            "wr_returned_time_sk": self.nullify(_int(rng.integers(0, 86400, m))),
            "wr_item_sk": _int(item[idx]),
            "wr_refunded_customer_sk": self.nullify(_int(rng.integers(1, self.n_cust + 1, m))),
            "wr_refunded_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, m))),
            "wr_refunded_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, m))),
            "wr_refunded_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, m))),
            "wr_returning_customer_sk": self.nullify(_int(rng.integers(1, self.n_cust + 1, m))),
            "wr_returning_cdemo_sk": self.nullify(_int(rng.integers(1, self.n_cdemo + 1, m))),
            "wr_returning_hdemo_sk": self.nullify(_int(rng.integers(1, self.n_hdemo + 1, m))),
            "wr_returning_addr_sk": self.nullify(_int(rng.integers(1, self.n_addr + 1, m))),
            "wr_web_page_sk": self.nullify(_int(rng.integers(1, self.n_wp + 1, m))),
            "wr_reason_sk": self.nullify(_int(rng.integers(1, self.n_reason + 1, m))),
            "wr_order_number": _int(order[idx]),
            "wr_return_quantity": self.nullify(_int(rng.integers(1, 10, m))),
            "wr_return_amt": self.nullify(_dec(amt)),
            "wr_return_tax": self.nullify(_dec(amt // 20)),
            "wr_return_amt_inc_tax": self.nullify(_dec(amt + amt // 20)),
            "wr_fee": self.nullify(_dec(fee)),
            "wr_return_ship_cost": self.nullify(_dec(amt // 10)),
            "wr_refunded_cash": self.nullify(_dec(amt // 2)),
            "wr_reversed_charge": self.nullify(_dec(amt // 4)),
            "wr_account_credit": self.nullify(_dec(amt // 4)),
            "wr_net_loss": self.nullify(_dec(amt // 3 + fee)),
        }

    def inventory(self, n_weeks=150):
        rng = self.rng
        # weekly snapshot: every item x a few warehouses on week boundaries
        week_starts = self.date_sks[::7][:n_weeks]
        items = np.arange(1, self.n_item + 1)
        wh = np.arange(1, self.n_wh + 1)
        d, it, w = np.meshgrid(week_starts, items, wh, indexing="ij")
        n = d.size
        self.tables["inventory"] = {
            "inv_date_sk": _int(d.ravel()),
            "inv_item_sk": _int(it.ravel()),
            "inv_warehouse_sk": _int(w.ravel()),
            "inv_quantity_on_hand": self.nullify(_int(rng.integers(0, 1000, n))),
        }


def generate(sf: float = 0.002, seed: int = 20031231) -> dict[str, TableStorage]:
    """Generate all 24 tables. sf=1 would approximate TPC-DS SF1 row counts;
    the default keeps the suite fast for differential testing."""
    g = _Gen(sf, seed)
    g.date_dim()
    g.time_dim()
    g.item(max(int(18000 * min(sf * 10, 1.0)), 200))
    g.geography(max(int(50000 * sf), 400))
    g.demographics()
    g.customer(max(int(100000 * sf), 500))
    g.small_dims(
        n_store=max(int(12 * max(sf * 10, 1)), 6),
        n_wh=max(int(5 * max(sf * 5, 1)), 3),
        n_web=max(int(30 * max(sf, 0.2)), 6),
        n_cc=max(int(6 * max(sf * 5, 1)), 4),
        n_wp=max(int(60 * max(sf * 5, 1)), 20),
        n_cp=max(int(11718 * sf), 100),
        n_promo=max(int(300 * max(sf * 5, 1)), 50),
    )
    d, i, t = g.store_sales(max(int(2_880_000 * sf), 4000))
    g.store_returns(d, i, t)
    d, i, o = g.catalog_sales(max(int(1_440_000 * sf), 2000))
    g.catalog_returns(d, i, o)
    d, i, o = g.web_sales(max(int(720_000 * sf), 1000))
    g.web_returns(d, i, o)
    g.inventory(n_weeks=max(int(150 * min(sf * 50, 1)), 20))

    out = {}
    for name, cols in g.tables.items():
        names = list(cols.keys())
        columns = list(cols.values())
        types = [c.type for c in columns]
        out[name] = TableStorage(name, names, types, columns, len(columns[0].data))
    return out


def load_into(session, sf: float = 0.002, seed: int = 20031231):
    return install(session, generate(sf, seed))


def install(session, tables: dict[str, TableStorage]):
    """Install already generated TPC-DS tables into a session's catalog; a
    table of runtime.device.SMALL_ROWS rows or more goes to the session's
    device on its first scan (two sessions may share one generated set:
    storage is read-only to queries)."""
    from ..catalog.catalog import TableEntry

    for name, storage in tables.items():
        session.catalog.tables[name] = TableEntry(
            name, storage.column_names, storage.column_types, [], storage)
    return tables


def to_sqlite(conn, tables: dict[str, TableStorage]):
    """Load the same data into sqlite3 (differential oracle)."""
    cur = conn.cursor()
    for name, t in tables.items():
        cols = ", ".join(t.column_names)
        cur.execute(f"CREATE TABLE {name} ({cols})")
        arrays = []
        for c in t.columns:
            if c.dictionary is not None:
                vals = c.dictionary[c.data]
            elif c.type.kind == K.DECIMAL:
                vals = c.data / (10 ** c.type.s)
            elif c.type.kind == K.DATE:
                vals = (EPOCH + c.data.astype("timedelta64[D]")).astype(str)
            else:
                vals = c.data
            if c.valid is not None:
                vals = np.where(c.valid, vals.astype(object), None)
            arrays.append(vals)
        rows = list(zip(*[a.tolist() for a in arrays]))
        ph = ",".join("?" * len(t.column_names))
        cur.executemany(f"INSERT INTO {name} VALUES ({ph})", rows)
        # surrogate-key indexes: without them sqlite nested-loops OR-of-ANDs
        # join predicates (q13/q48) for minutes on the 274k-row dims
        for cname in t.column_names:
            if cname.endswith("_sk"):
                cur.execute(f"CREATE INDEX idx_{name}_{cname} ON {name}({cname})")
    cur.execute("ANALYZE")
    conn.commit()
