"""Unit tables for the MEASURE converter.

Role-equivalent to the reference's inline unit dictionaries
(reference: converters/Measure.py:86-445): SI prefixes × prefixable base
units, plus a table of standalone/customary units. Values are
(singular, plural) pairs.

A copy of ``pl_bert_tpu/text/converters/measure_data.py`` (1-121).
"""

SI_PREFIXES = {
    "Y": "yotta", "Z": "zetta", "E": "exa", "P": "peta", "T": "tera",
    "G": "giga", "M": "mega", "k": "kilo", "h": "hecto", "da": "deca",
    "d": "deci", "c": "centi", "m": "milli", "μ": "micro", "µ": "micro",
    "n": "nano", "p": "pico", "f": "femto", "a": "atto", "z": "zepto",
    "y": "yocto",
}

# base units that accept SI prefixes (symbol → (singular, plural))
PREFIXABLE_UNITS = {
    "m": ("meter", "meters"),
    "b": ("bit", "bits"),
    "B": ("byte", "bytes"),
    "bps": ("bit per second", "bits per second"),
    "Bps": ("byte per second", "bytes per second"),
    "g": ("gram", "grams"),
    "gf": ("gram force", "grams force"),
    "W": ("watt", "watts"),
    "Wh": ("watt hour", "watt hours"),
    "Hz": ("hertz", "hertz"),
    "hz": ("hertz", "hertz"),
    "J": ("joule", "joules"),
    "L": ("liter", "liters"),
    "V": ("volt", "volts"),
    "f": ("farad", "farads"),
    "s": ("second", "seconds"),
    "A": ("ampere", "amperes"),
    "Ah": ("amp hour", "amp hours"),
    "Pa": ("pascal", "pascals"),
    "C": ("coulomb", "coulombs"),
    "Bq": ("becquerel", "becquerels"),
    "N": ("newton", "newtons"),
    "bar": ("bar", "bars"),
    "lm": ("lumen", "lumens"),
    "cal": ("calorie", "calories"),
}

# standalone units and overrides (take precedence over prefixed forms)
CUSTOM_UNITS = {
    "%": ("percent", "percent"),
    "pc": ("percent", "percent"),
    "ft": ("foot", "feet"),
    "mi": ("mile", "miles"),
    "mb": ("megabyte", "megabytes"),
    "ha": ("hectare", "hectares"),
    '"': ("inch", "inches"),
    "in": ("inch", "inches"),
    "'": ("foot", "feet"),
    "rpm": ("revolution per minute", "revolutions per minute"),
    "hp": ("horsepower", "horsepower"),
    "cc": ("c c", "c c"),
    "oz": ("ounce", "ounces"),
    "mph": ("mile per hour", "miles per hour"),
    "lb": ("pound", "pounds"),
    "lbs": ("pounds", "pounds"),
    "kt": ("knot", "knots"),
    "kts": ("knot", "knots"),
    "dB": ("decibel", "decibels"),
    "AU": ("astronomical unit", "astronomical units"),
    "st": ("stone", "stone"),
    "yd": ("yard", "yards"),
    "yr": ("year", "years"),
    "yrs": ("year", "years"),
    "eV": ("electron volt", "electron volts"),
    "/": ("per", "per"),
    "sq": ("square", "square"),
    "2": ("square", "square"),
    "²": ("square", "square"),
    "3": ("cubic", "cubic"),
    "³": ("cubic", "cubic"),
    "h": ("hour", "hours"),
    "hr": ("hour", "hours"),
    "hrs": ("hour", "hours"),
    "ch": ("chain", "chains"),
    "KiB": ("kibibyte", "kibibytes"),
    "MiB": ("mebibyte", "mebibytes"),
    "GiB": ("gibibyte", "gibibytes"),
    "pH": ("p h", "p h"),
    "kph": ("kilometer per hour", "kilometers per hour"),
    "Da": ("dalton", "daltons"),
    "cwt": ("hundredweight", "hundredweight"),
    "Sv": ("sievert", "sieverts"),
    "C": ("celcius", "celcius"),  # overrides coulomb for bare "C"
    "degrees": ("degree", "degrees"),
    "degree": ("degree", "degrees"),
    "atm": ("atmosphere", "atmospheres"),
    "min": ("minute", "minutes"),
    "cd": ("candela", "candelas"),
    "ly": ("light year", "light years"),
    "mol": ("mole", "moles"),
    "Nm": ("newton meter", "newton meters"),
    "Ω": ("ohm", "ohms"),
    "bbl": ("barrel", "barrels"),
    "gal": ("gallon", "gallons"),
    "cal": ("cal", "cal"),  # bare "cal" reads as caliber, kcal stays calorie
}


def build_unit_table() -> tuple[dict, dict]:
    """Expand prefix×unit product and overlay custom units.

    Returns (case_sensitive, lowercase) lookup dicts of
    symbol → (singular, plural).
    """
    table = {
        prefix_sym + unit_sym: (prefix_name + names[0], prefix_name + names[1])
        for unit_sym, names in PREFIXABLE_UNITS.items()
        for prefix_sym, prefix_name in SI_PREFIXES.items()
    }
    table.update(PREFIXABLE_UNITS)
    table.update(CUSTOM_UNITS)
    lower = {sym.lower(): names for sym, names in table.items()}
    return table, lower
