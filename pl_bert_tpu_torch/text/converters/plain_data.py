"""Word-substitution table for the PLAIN converter.

Role-equivalent to the reference's plain.json (650 entries trained against
the Kaggle text-normalization data; reference: converters/Plain.py:41).
This table is written fresh: common abbreviations plus the regular UK→US
spelling families the reference table encodes. It is a data surface —
extend freely.

A copy of ``pl_bert_tpu/text/converters/plain_data.py`` (1-241).
"""

ABBREVIATIONS = {
    "vol": "volume",
    "vs": "versus",
    "v": "versus",
    "st": "saint",
    "mt": "mount",
    "ft": "fort",
    "no": "number",
    "etc": "etcetera",
    "jr": "junior",
    "sr": "senior",
    "mr": "mister",
    "mrs": "missus",
    "dr": "doctor",
    "prof": "professor",
    "gen": "general",
    "col": "colonel",
    "capt": "captain",
    "lt": "lieutenant",
    "sgt": "sergeant",
    "rev": "reverend",
    "hon": "honorable",
    "gov": "governor",
    "sen": "senator",
    "rep": "representative",
    "pres": "president",
    "dept": "department",
    "univ": "university",
    "inst": "institute",
    "assn": "association",
    "bros": "brothers",
    "inc": "incorporated",
    "ltd": "limited",
    "corp": "corporation",
    "co": "company",
    "ave": "avenue",
    "blvd": "boulevard",
    "rd": "road",
    "hwy": "highway",
    "pkwy": "parkway",
    "sq": "square",
    "apt": "apartment",
    "ste": "suite",
    "bldg": "building",
    "jan": "january",
    "feb": "february",
    "mar": "march",
    "apr": "april",
    "jun": "june",
    "jul": "july",
    "aug": "august",
    "sep": "september",
    "sept": "september",
    "oct": "october",
    "nov": "november",
    "dec": "december",
    "mon": "monday",
    "tue": "tuesday",
    "wed": "wednesday",
    "thu": "thursday",
    "fri": "friday",
    "sat": "saturday",
    "sun": "sunday",
    "approx": "approximately",
    "est": "established",
    "min": "minimum",
    "max": "maximum",
    "misc": "miscellaneous",
    "govt": "government",
    "intl": "international",
    "int'l": "international",
    "natl": "national",
    "-": "to",
    "w/": "with",
    # standard place/rank/unit abbreviations (round 4: common-knowledge
    # entries; the reference's remaining Kaggle-trained table is
    # deliberately NOT reproduced — see PARITY.md §Plain)
    "mtn": "mountain",
    "cir": "circle",
    "pvt": "private",
    "cpl": "corporal",
    "maj": "major",
    "adm": "admiral",
    "cmdr": "commander",
    "wy": "way",
    "pl": "place",
    "ln": "lane",
    "ct": "court",
    "terr": "terrace",
    "jct": "junction",
    "twp": "township",
    "yr": "year",
    "hr": "hour",
    "wk": "week",
    "tues": "tuesday",
    "thurs": "thursday",
    "mgmt": "management",
    "esp": "especially",
    "sqn": "squadron",
    "ok": "okay",
    "cos": "cause",
    "lb": "pound",
    "lbs": "pounds",
    "oz": "ounce",
    "qty": "quantity",
    "avg": "average",
    "asst": "assistant",
    "attn": "attention",
    "appt": "appointment",
    "amt": "amount",
    "fwd": "forward",
    "pct": "percent",
    "pkg": "package",
    "qtr": "quarter",
    "tel": "telephone",
    "fig": "figure",
    "ctrl": "control",
    "ctr": "center",
    "mins": "minutes",
    "crk": "creek",
    "expwy": "expressway",
    "tpk": "turnpike",
    "mdw": "meadow",
    "cuz": "cause",
}

# Regular UK→US spelling families, expanded to concrete pairs below.
_OUR_OR = [
    "colour", "flavour", "honour", "labour", "neighbour", "behaviour",
    "favour", "harbour", "humour", "rumour", "armour", "vapour", "odour",
    "savour", "valour", "vigour", "candour", "clamour", "endeavour",
    "splendour", "tumour",
]
_RE_ER = [
    "centre", "theatre", "metre", "litre", "fibre", "calibre", "sombre",
    "spectre", "lustre", "manoeuvre", "meagre", "sabre", "sceptre",
]
_ISE_IZE = [
    "organise", "recognise", "realise", "criticise", "emphasise",
    "apologise", "authorise", "categorise", "characterise", "civilise",
    "colonise", "customise", "dramatise", "economise", "equalise",
    "familiarise", "fertilise", "finalise", "generalise", "harmonise",
    "hospitalise", "hypothesise", "idealise", "immunise", "industrialise",
    "legalise", "localise", "maximise", "memorise", "minimise",
    "mobilise", "modernise", "monopolise", "nationalise", "neutralise",
    "normalise", "optimise", "patronise", "penalise", "personalise",
    "popularise", "prioritise", "privatise", "publicise", "rationalise",
    "revolutionise", "romanticise", "scrutinise", "specialise",
    "stabilise", "standardise", "sterilise", "stigmatise", "subsidise",
    "summarise", "symbolise", "sympathise", "synthesise", "systematise",
    "terrorise", "theorise", "utilise", "vandalise", "visualise",
    "vocalise",
]
_YSE_YZE = ["analyse", "paralyse", "catalyse", "hydrolyse"]
_IRREGULAR = {
    "grey": "gray",
    "tyre": "tire",
    "kerb": "curb",
    "plough": "plow",
    "mould": "mold",
    "moult": "molt",
    "smoulder": "smolder",
    "cheque": "check",
    "gaol": "jail",
    "draught": "draft",
    "aluminium": "aluminum",
    "aeroplane": "airplane",
    "artefact": "artifact",
    "defence": "defense",
    "offence": "offense",
    "licence": "license",
    "pretence": "pretense",
    "practise": "practice",
    "programme": "program",
    "catalogue": "catalog",
    "dialogue": "dialog",
    "travelled": "traveled",
    "travelling": "traveling",
    "traveller": "traveler",
    "cancelled": "canceled",
    "cancelling": "canceling",
    "labelled": "labeled",
    "labelling": "labeling",
    "modelled": "modeled",
    "modelling": "modeling",
    "signalling": "signaling",
    "marvellous": "marvelous",
    "jewellery": "jewelry",
    "woollen": "woolen",
    "enrol": "enroll",
    "fulfil": "fulfill",
    "instalment": "installment",
    "skilful": "skillful",
    "wilful": "willful",
    "encyclopaedia": "encyclopedia",
    "mediaeval": "medieval",
    "anaemia": "anemia",
    "anaesthesia": "anesthesia",
    "diarrhoea": "diarrhea",
    "foetus": "fetus",
    "oestrogen": "estrogen",
    "paediatric": "pediatric",
    "archaeology": "archeology",
    "manoeuvre": "maneuver",
    "oesophagus": "esophagus",
}


def _build() -> dict[str, str]:
    table = dict(ABBREVIATIONS)
    for uk in _OUR_OR:
        us = uk.replace("our", "or")
        table[uk] = us
        # common derived forms
        table[uk + "s"] = us + "s"
        table[uk + "ed"] = us + "ed"
        table[uk + "ing"] = us + "ing"
    for uk in _RE_ER:
        table[uk] = uk[:-2] + "er"
        table[uk + "s"] = uk[:-2] + "ers"
    for uk in _ISE_IZE + _YSE_YZE:
        us = uk[:-3] + ("yze" if uk.endswith("yse") else "ize")
        table[uk] = us
        table[uk + "s"] = us + "s"
        table[uk + "d"] = us + "d"
        table[uk[:-1] + "ing"] = us[:-1] + "ing"
        table[uk[:-1] + "ation"] = us[:-1] + "ation"
    table.update(_IRREGULAR)
    return table


PLAIN_WORDS: dict[str, str] = _build()
