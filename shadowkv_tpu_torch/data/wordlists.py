"""Self-contained word/city lists for the synthetic benchmark generators.

The reference pulls word lists from the ``wonderwords`` package
(reference data/ruler/synthetic/niah.py:91-95) and a hardcoded city list
(reference data/utils.py:55). This environment has no ``wonderwords``
and no network egress, so the lists live here. Sizes are chosen so the
cross products (adj-noun needle keys) stay in the tens of thousands,
matching the diversity the generators need.
"""

from __future__ import annotations

import random
import uuid

NOUNS = """
time year people way day man thing woman life child world school state
family student group country problem hand part place case week company
system program question work government number night point home water
room mother area money story fact month lot right study book eye job
word business issue side kind head house service friend father power
hour game line end member law car city community name president team
minute idea body information back parent face others level office door
health person art war history party result change morning reason
research girl guy moment air teacher force education foot boy age
policy process music market sense nation plan college interest death
experience effect use class control care field development role effort
rate heart drug show leader light voice wife whole police mind price
report decision son view relationship town road arm difference value
building action model season society tax director position player
record paper space ground form event official matter center couple
site project activity star table need court oil situation cost industry
figure street tree phone bank data picture practice piece land product
doctor wall patient worker news test movie north love support technology
""".split()

ADJECTIVES = """
different used important every large available popular able basic known
various difficult several united historical hot useful mental scared
additional emotional old political similar healthy financial medical
traditional federal entire strong actual significant successful
electrical expensive pregnant intelligent interesting poor happy
responsible cute helpful recent willing nice wonderful impossible
serious huge rare technical typical competitive critical electronic
immediate aware educational environmental global legal relevant
accurate capable dangerous dramatic efficient powerful foreign hungry
practical psychological severe suitable numerous sufficient unusual
consistent cultural existing famous pure afraid obvious careful latter
unhappy acceptable aggressive distinct eastern logical reasonable
strict administrative automatic civil former massive southern unfair
visible alive angry desperate exciting friendly lucky realistic sorry
ugly unlikely anxious comprehensive curious impressive informal inner
pleasant sexual sudden terrible unable weird wooden asleep confident
conscious decent embarrassed guilty lonely mad nervous odd remarkable
substantial suspicious tall tiny more some good new first last long
great little own other old right big high small
""".split()

VERBS = """
accept allow appear ask become begin believe borrow break bring build
buy cancel change clean comb complain cough count cut dance draw drink
drive eat explain fall fill find finish fit fix fly forget give go have
hear hurt know learn leave listen live look lose make need open close
shut organize pay play put rain read reply run say see sell send sign
sing sit sleep smoke speak spell spend stand study succeed swim take
talk teach tell think translate travel try turn off wake walk want
watch work worry write carry decide double matter offer prepare prevent
pretend promise protect provide pull punch push raise reach realize
receive recognize recommend remember remove repair repeat replace
reply report require rescue retire return rub save scratch search
separate serve settle shake share shave shine shoot shout show sink
ski slide smell smile sneeze solve sound spill spit spread stick sting
stop stretch suffer suggest supply support suppose surprise survive
suspect swear sweep swell
""".split()

# City names for the NIAH "special magic number" needles (reference
# data/utils.py:55 uses a 100-entry list with repeats; dedup'd here).
CITIES = [
    "Chicago", "Yangon", "Antananarivo", "Colombo", "Almaty", "Sydney",
    "Mexico City", "Seattle", "Lagos", "Amsterdam", "Belgrade", "Cairo",
    "Baghdad", "Damascus", "Kigali", "Dakar", "Sofia", "Victoria",
    "Tashkent", "Mumbai", "Barcelona", "Amman", "Toronto", "Bratislava",
    "Johannesburg", "Thimphu", "Bangkok", "Santiago", "San Francisco",
    "Paris", "Rabat", "Copenhagen", "Madrid", "Ho Chi Minh City",
    "Sarajevo", "Delhi", "Istanbul", "Khartoum", "Helsinki", "Doha",
    "Kuala Lumpur", "Budapest", "Shanghai", "Moscow", "Los Angeles",
    "Oslo", "Berlin", "Bangalore", "Tokyo", "Melbourne", "Port Louis",
    "Lisbon", "Nairobi", "Kampala", "Lima", "Maputo", "Vancouver",
    "Dubai", "Jakarta", "Yerevan", "Beirut", "Athens", "Bucharest",
    "Brussels", "Tunis", "Astana", "Seoul", "Buenos Aires", "Vienna",
]


def adjective_noun_words() -> list[str]:
    """Hyphenated adj-noun compounds used as NIAH needle keys
    (reference data/ruler/synthetic/niah.py:94)."""
    return sorted({f"{a}-{n}" for a in ADJECTIVES for n in NOUNS})


def all_words() -> list[str]:
    """Combined vocabulary for common-words extraction
    (reference data/ruler/synthetic/common_words_extraction.py:65-69)."""
    return sorted(set(NOUNS + ADJECTIVES + VERBS))


def random_number(rng: random.Random, num_digits: int = 7) -> str:
    return str(rng.randint(10 ** (num_digits - 1), 10**num_digits - 1))


def random_uuid(rng: random.Random) -> str:
    return str(uuid.UUID(int=rng.getrandbits(128), version=4))


def synthetic_essay(rng: random.Random, num_words: int) -> str:
    """Deterministic filler prose for the 'essay' haystack.

    The reference downloads Paul Graham essays
    (data/ruler/synthetic/niah.py:74-80); with zero egress we synthesize
    sentence-shaped filler from the word lists instead. Content is
    irrelevant to the tasks — it only has to be plausible, varied text
    the needle can hide in.
    """
    out: list[str] = []
    n = 0
    while n < num_words:
        length = rng.randint(6, 14)
        words = []
        for i in range(length):
            pool = (NOUNS, VERBS, ADJECTIVES)[rng.randint(0, 2)]
            words.append(rng.choice(pool))
        words[0] = words[0].capitalize()
        out.append(" ".join(words) + ".")
        n += length
    return " ".join(out)
