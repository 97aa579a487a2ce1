"""Word stemmers for METEOR's stem stage, in pure Python.

Ports of two stemmers of NLTK 3.10 (``nltk/stem/porter.py`` and the
English stemmer of ``nltk/stem/snowball.py``), so that the port scores
METEOR on a machine without nltk:

* ``PorterStemmer``: NLTK's ``PorterStemmer()`` in its default
  ``NLTK_EXTENSIONS`` mode (Porter 1980 with Martin Porter's and NLTK's
  extensions, the pool of irregular forms, lower-casing).  METEOR's
  ``meteor2005`` profile stems with it.
* ``EnglishStemmer``: NLTK's ``SnowballStemmer("english")`` (the
  Snowball "Porter2" algorithm, no stop words).  The ``meteor15-en``
  profile stems with it, as the METEOR 1.5 jar does.

Each step, rule list and condition is NLTK's, in NLTK's order; the
modes and languages the port does not use are left out.

NLTK is Copyright (C) 2001-2026 NLTK Project and is licensed under the
Apache License, Version 2.0 (http://www.apache.org/licenses/LICENSE-2.0).
The stemming algorithms are Dr Martin Porter's.
"""

from __future__ import annotations


def _suffix_replace(original: str, old: str, new: str) -> str:
    return original[: -len(old)] + new


class PorterStemmer:
    """NLTK's ``PorterStemmer`` in ``NLTK_EXTENSIONS`` mode."""

    # irregular forms, looked up before any step
    _IRREGULAR = {
        "sky": ["sky", "skies"],
        "die": ["dying"],
        "lie": ["lying"],
        "tie": ["tying"],
        "news": ["news"],
        "inning": ["innings", "inning"],
        "outing": ["outings", "outing"],
        "canning": ["cannings", "canning"],
        "howe": ["howe"],
        "proceed": ["proceed"],
        "exceed": ["exceed"],
        "succeed": ["succeed"],
    }

    def __init__(self):
        self.pool = {v: k for k, vals in self._IRREGULAR.items()
                     for v in vals}
        self.vowels = frozenset("aeiou")

    def _is_consonant(self, word: str, i: int) -> bool:
        """A letter other than a, e, i, o, u, and other than a y preceded
        by a consonant (a run of y's alternates)."""
        if word[i] in self.vowels:
            return False
        if word[i] == "y":
            negate = False
            while i > 0 and word[i] == "y":
                negate = not negate
                i -= 1
            return (word[i] not in self.vowels) != negate
        return True

    def _measure(self, stem: str) -> int:
        """m of [C](VC){m}[V]: the number of 'vc' in the c/v sequence."""
        cv = "".join("c" if self._is_consonant(stem, i) else "v"
                     for i in range(len(stem)))
        return cv.count("vc")

    def _has_positive_measure(self, stem: str) -> bool:
        return self._measure(stem) > 0

    def _contains_vowel(self, stem: str) -> bool:
        return any(not self._is_consonant(stem, i) for i in range(len(stem)))

    def _ends_double_consonant(self, word: str) -> bool:
        return (len(word) >= 2 and word[-1] == word[-2]
                and self._is_consonant(word, len(word) - 1))

    def _ends_cvc(self, word: str) -> bool:
        return (
            len(word) >= 3
            and self._is_consonant(word, len(word) - 3)
            and not self._is_consonant(word, len(word) - 2)
            and self._is_consonant(word, len(word) - 1)
            and word[-1] not in ("w", "x", "y")
        ) or (
            len(word) == 2
            and not self._is_consonant(word, 0)
            and self._is_consonant(word, 1)
        )

    @staticmethod
    def _replace_suffix(word: str, suffix: str, replacement: str) -> str:
        assert word.endswith(suffix), \
            "Given word doesn't end with given suffix"
        if suffix == "":
            return word + replacement
        return word[: -len(suffix)] + replacement

    def _apply_rule_list(self, word: str, rules) -> str:
        """The first rule whose suffix matches decides: its replacement if
        its condition holds, else the word unchanged."""
        for suffix, replacement, condition in rules:
            if suffix == "*d" and self._ends_double_consonant(word):
                stem = word[:-2]
                if condition is None or condition(stem):
                    return stem + replacement
                return word
            if word.endswith(suffix):
                stem = self._replace_suffix(word, suffix, "")
                if condition is None or condition(stem):
                    return stem + replacement
                return word
        return word

    def _step1a(self, word: str) -> str:
        if word.endswith("ies") and len(word) == 4:
            return self._replace_suffix(word, "ies", "ie")
        return self._apply_rule_list(word, [
            ("sses", "ss", None),
            ("ies", "i", None),
            ("ss", "ss", None),
            ("s", "", None),
        ])

    def _step1b(self, word: str) -> str:
        if word.endswith("ied"):
            if len(word) == 4:
                return self._replace_suffix(word, "ied", "ie")
            return self._replace_suffix(word, "ied", "i")
        if word.endswith("eed"):
            stem = self._replace_suffix(word, "eed", "")
            if self._measure(stem) > 0:
                return stem + "ee"
            return word
        rule_2_or_3_succeeded = False
        for suffix in ["ed", "ing"]:
            if word.endswith(suffix):
                intermediate_stem = self._replace_suffix(word, suffix, "")
                if self._contains_vowel(intermediate_stem):
                    rule_2_or_3_succeeded = True
                    break
        if not rule_2_or_3_succeeded:
            return word
        return self._apply_rule_list(intermediate_stem, [
            ("at", "ate", None),
            ("bl", "ble", None),
            ("iz", "ize", None),
            ("*d", intermediate_stem[-1],
             lambda stem: intermediate_stem[-1] not in ("l", "s", "z")),
            ("", "e",
             lambda stem: (self._measure(stem) == 1
                           and self._ends_cvc(stem))),
        ])

    def _step1c(self, word: str) -> str:
        return self._apply_rule_list(word, [(
            "y", "i",
            lambda stem: (len(stem) > 1
                          and self._is_consonant(stem, len(stem) - 1)))])

    def _step2(self, word: str) -> str:
        pos = self._has_positive_measure
        if word.endswith("alli") and pos(
                self._replace_suffix(word, "alli", "")):
            return self._step2(self._replace_suffix(word, "alli", "al"))
        rules = [
            ("ational", "ate", pos),
            ("tional", "tion", pos),
            ("enci", "ence", pos),
            ("anci", "ance", pos),
            ("izer", "ize", pos),
            ("bli", "ble", pos),
            ("alli", "al", pos),
            ("entli", "ent", pos),
            ("eli", "e", pos),
            ("ousli", "ous", pos),
            ("ization", "ize", pos),
            ("ation", "ate", pos),
            ("ator", "ate", pos),
            ("alism", "al", pos),
            ("iveness", "ive", pos),
            ("fulness", "ful", pos),
            ("ousness", "ous", pos),
            ("aliti", "al", pos),
            ("iviti", "ive", pos),
            ("biliti", "ble", pos),
            ("fulli", "ful", pos),
            ("logi", "log", lambda stem: pos(word[:-3])),
        ]
        return self._apply_rule_list(word, rules)

    def _step3(self, word: str) -> str:
        pos = self._has_positive_measure
        return self._apply_rule_list(word, [
            ("icate", "ic", pos),
            ("ative", "", pos),
            ("alize", "al", pos),
            ("iciti", "ic", pos),
            ("ical", "ic", pos),
            ("ful", "", pos),
            ("ness", "", pos),
        ])

    def _step4(self, word: str) -> str:
        def gt1(stem):
            return self._measure(stem) > 1
        return self._apply_rule_list(word, [
            ("al", "", gt1),
            ("ance", "", gt1),
            ("ence", "", gt1),
            ("er", "", gt1),
            ("ic", "", gt1),
            ("able", "", gt1),
            ("ible", "", gt1),
            ("ant", "", gt1),
            ("ement", "", gt1),
            ("ment", "", gt1),
            ("ent", "", gt1),
            ("ion", "",
             lambda stem: self._measure(stem) > 1 and stem[-1] in ("s", "t")),
            ("ou", "", gt1),
            ("ism", "", gt1),
            ("ate", "", gt1),
            ("iti", "", gt1),
            ("ous", "", gt1),
            ("ive", "", gt1),
            ("ize", "", gt1),
        ])

    def _step5a(self, word: str) -> str:
        # both conditions of the two E rules are tried, so no rule list
        if word.endswith("e"):
            stem = self._replace_suffix(word, "e", "")
            if self._measure(stem) > 1:
                return stem
            if self._measure(stem) == 1 and not self._ends_cvc(stem):
                return stem
        return word

    def _step5b(self, word: str) -> str:
        return self._apply_rule_list(
            word, [("ll", "l", lambda stem: self._measure(word[:-1]) > 1)])

    def stem(self, word: str, to_lowercase: bool = True) -> str:
        stem = word.lower() if to_lowercase else word
        if stem in self.pool:
            return self.pool[stem]
        if len(word) <= 2:
            return stem
        stem = self._step1a(stem)
        stem = self._step1b(stem)
        stem = self._step1c(stem)
        stem = self._step2(stem)
        stem = self._step3(stem)
        stem = self._step4(stem)
        stem = self._step5a(stem)
        stem = self._step5b(stem)
        return stem


class EnglishStemmer:
    """NLTK's ``SnowballStemmer("english")`` (no stop words)."""

    _vowels = "aeiouy"
    _double_consonants = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr",
                          "tt")
    _li_ending = "cdeghkmnrt"
    _step0_suffixes = ("'s'", "'s", "'")
    _step1a_suffixes = ("sses", "ied", "ies", "us", "ss", "s")
    _step1b_suffixes = ("eedly", "ingly", "edly", "eed", "ing", "ed")
    _step2_suffixes = (
        "ization", "ational", "fulness", "ousness", "iveness", "tional",
        "biliti", "lessli", "entli", "ation", "alism", "aliti", "ousli",
        "iviti", "fulli", "enci", "anci", "abli", "izer", "ator", "alli",
        "bli", "ogi", "li")
    _step3_suffixes = ("ational", "tional", "alize", "icate", "iciti",
                       "ative", "ical", "ness", "ful")
    _step4_suffixes = ("ement", "ance", "ence", "able", "ible", "ment",
                       "ant", "ent", "ism", "ate", "iti", "ous", "ive",
                       "ize", "ion", "al", "er", "ic")
    _special_words = {
        "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
        "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
        "early": "earli", "only": "onli", "singly": "singl", "sky": "sky",
        "news": "news", "howe": "howe", "atlas": "atlas",
        "cosmos": "cosmos", "bias": "bias", "andes": "andes",
        "inning": "inning", "innings": "inning", "outing": "outing",
        "outings": "outing", "canning": "canning", "cannings": "canning",
        "herring": "herring", "herrings": "herring", "earring": "earring",
        "earrings": "earring", "proceed": "proceed",
        "proceeds": "proceed", "proceeded": "proceed",
        "proceeding": "proceed", "exceed": "exceed", "exceeds": "exceed",
        "exceeded": "exceed", "exceeding": "exceed",
        "succeed": "succeed", "succeeds": "succeed",
        "succeeded": "succeed", "succeeding": "succeed",
    }

    def _r1r2_standard(self, word: str):
        """R1: the region after the first non-vowel that follows a vowel;
        R2: the same region within R1."""
        vowels = self._vowels
        r1 = ""
        r2 = ""
        for i in range(1, len(word)):
            if word[i] not in vowels and word[i - 1] in vowels:
                r1 = word[i + 1:]
                break
        for i in range(1, len(r1)):
            if r1[i] not in vowels and r1[i - 1] in vowels:
                r2 = r1[i + 1:]
                break
        return r1, r2

    def stem(self, word: str) -> str:
        vowels = self._vowels
        word = word.lower()
        if len(word) <= 2:
            return word
        if word in self._special_words:
            return self._special_words[word]

        word = (word.replace("\u2019", "\x27").replace("\u2018", "\x27")
                .replace("\u201b", "\x27"))
        if word.startswith("\x27"):
            word = word[1:]
        if word.startswith("y"):
            word = "".join(("Y", word[1:]))
        for i in range(1, len(word)):
            if word[i - 1] in vowels and word[i] == "y":
                word = "".join((word[:i], "Y", word[i + 1:]))

        step1a_vowel_found = False
        step1b_vowel_found = False
        r1 = ""
        r2 = ""
        if word.startswith(("gener", "commun", "arsen")):
            if word.startswith(("gener", "arsen")):
                r1 = word[5:]
            else:
                r1 = word[6:]
            for i in range(1, len(r1)):
                if r1[i] not in vowels and r1[i - 1] in vowels:
                    r2 = r1[i + 1:]
                    break
        else:
            r1, r2 = self._r1r2_standard(word)

        # step 0
        for suffix in self._step0_suffixes:
            if word.endswith(suffix):
                word = word[: -len(suffix)]
                r1 = r1[: -len(suffix)]
                r2 = r2[: -len(suffix)]
                break

        # step 1a
        for suffix in self._step1a_suffixes:
            if word.endswith(suffix):
                if suffix == "sses":
                    word = word[:-2]
                    r1 = r1[:-2]
                    r2 = r2[:-2]
                elif suffix in ("ied", "ies"):
                    if len(word[: -len(suffix)]) > 1:
                        word = word[:-2]
                        r1 = r1[:-2]
                        r2 = r2[:-2]
                    else:
                        word = word[:-1]
                        r1 = r1[:-1]
                        r2 = r2[:-1]
                elif suffix == "s":
                    for letter in word[:-2]:
                        if letter in vowels:
                            step1a_vowel_found = True
                            break
                    if step1a_vowel_found:
                        word = word[:-1]
                        r1 = r1[:-1]
                        r2 = r2[:-1]
                break

        # step 1b
        for suffix in self._step1b_suffixes:
            if word.endswith(suffix):
                if suffix in ("eed", "eedly"):
                    if r1.endswith(suffix):
                        word = _suffix_replace(word, suffix, "ee")
                        if len(r1) >= len(suffix):
                            r1 = _suffix_replace(r1, suffix, "ee")
                        else:
                            r1 = ""
                        if len(r2) >= len(suffix):
                            r2 = _suffix_replace(r2, suffix, "ee")
                        else:
                            r2 = ""
                else:
                    for letter in word[: -len(suffix)]:
                        if letter in vowels:
                            step1b_vowel_found = True
                            break
                    if step1b_vowel_found:
                        word = word[: -len(suffix)]
                        r1 = r1[: -len(suffix)]
                        r2 = r2[: -len(suffix)]
                        if word.endswith(("at", "bl", "iz")):
                            word = "".join((word, "e"))
                            r1 = "".join((r1, "e"))
                            if len(word) > 5 or len(r1) >= 3:
                                r2 = "".join((r2, "e"))
                        elif word.endswith(self._double_consonants):
                            word = word[:-1]
                            r1 = r1[:-1]
                            r2 = r2[:-1]
                        elif (
                            r1 == ""
                            and len(word) >= 3
                            and word[-1] not in vowels
                            and word[-1] not in "wxY"
                            and word[-2] in vowels
                            and word[-3] not in vowels
                        ) or (
                            r1 == ""
                            and len(word) == 2
                            and word[0] in vowels
                            and word[1] not in vowels
                        ):
                            word = "".join((word, "e"))
                            if len(r1) > 0:
                                r1 = "".join((r1, "e"))
                            if len(r2) > 0:
                                r2 = "".join((r2, "e"))
                break

        # step 1c
        if len(word) > 2 and word[-1] in "yY" and word[-2] not in vowels:
            word = "".join((word[:-1], "i"))
            if len(r1) >= 1:
                r1 = "".join((r1[:-1], "i"))
            else:
                r1 = ""
            if len(r2) >= 1:
                r2 = "".join((r2[:-1], "i"))
            else:
                r2 = ""

        # step 2
        for suffix in self._step2_suffixes:
            if word.endswith(suffix):
                if r1.endswith(suffix):
                    if suffix == "tional":
                        word = word[:-2]
                        r1 = r1[:-2]
                        r2 = r2[:-2]
                    elif suffix in ("enci", "anci", "abli"):
                        word = "".join((word[:-1], "e"))
                        if len(r1) >= 1:
                            r1 = "".join((r1[:-1], "e"))
                        else:
                            r1 = ""
                        if len(r2) >= 1:
                            r2 = "".join((r2[:-1], "e"))
                        else:
                            r2 = ""
                    elif suffix == "entli":
                        word = word[:-2]
                        r1 = r1[:-2]
                        r2 = r2[:-2]
                    elif suffix in ("izer", "ization"):
                        word, r1, r2 = self._replace3(word, r1, r2, suffix,
                                                      "ize", "")
                    elif suffix in ("ational", "ation", "ator"):
                        word, r1, r2 = self._replace3(word, r1, r2, suffix,
                                                      "ate", "e")
                    elif suffix in ("alism", "aliti", "alli"):
                        word, r1, r2 = self._replace3(word, r1, r2, suffix,
                                                      "al", "")
                    elif suffix == "fulness":
                        word = word[:-4]
                        r1 = r1[:-4]
                        r2 = r2[:-4]
                    elif suffix in ("ousli", "ousness"):
                        word, r1, r2 = self._replace3(word, r1, r2, suffix,
                                                      "ous", "")
                    elif suffix in ("iveness", "iviti"):
                        word, r1, r2 = self._replace3(word, r1, r2, suffix,
                                                      "ive", "e")
                    elif suffix in ("biliti", "bli"):
                        word, r1, r2 = self._replace3(word, r1, r2, suffix,
                                                      "ble", "")
                    elif suffix == "ogi" and word[-4] == "l":
                        word = word[:-1]
                        r1 = r1[:-1]
                        r2 = r2[:-1]
                    elif suffix in ("fulli", "lessli"):
                        word = word[:-2]
                        r1 = r1[:-2]
                        r2 = r2[:-2]
                    elif suffix == "li" and word[-3] in self._li_ending:
                        word = word[:-2]
                        r1 = r1[:-2]
                        r2 = r2[:-2]
                break

        # step 3
        for suffix in self._step3_suffixes:
            if word.endswith(suffix):
                if r1.endswith(suffix):
                    if suffix == "tional":
                        word = word[:-2]
                        r1 = r1[:-2]
                        r2 = r2[:-2]
                    elif suffix == "ational":
                        word, r1, r2 = self._replace3(word, r1, r2, suffix,
                                                      "ate", "")
                    elif suffix == "alize":
                        word = word[:-3]
                        r1 = r1[:-3]
                        r2 = r2[:-3]
                    elif suffix in ("icate", "iciti", "ical"):
                        word, r1, r2 = self._replace3(word, r1, r2, suffix,
                                                      "ic", "")
                    elif suffix in ("ful", "ness"):
                        word = word[: -len(suffix)]
                        r1 = r1[: -len(suffix)]
                        r2 = r2[: -len(suffix)]
                    elif suffix == "ative" and r2.endswith(suffix):
                        word = word[:-5]
                        r1 = r1[:-5]
                        r2 = r2[:-5]
                break

        # step 4
        for suffix in self._step4_suffixes:
            if word.endswith(suffix):
                if r2.endswith(suffix):
                    if suffix == "ion":
                        if word[-4] in "st":
                            word = word[:-3]
                            r1 = r1[:-3]
                            r2 = r2[:-3]
                    else:
                        word = word[: -len(suffix)]
                        r1 = r1[: -len(suffix)]
                        r2 = r2[: -len(suffix)]
                break

        # step 5
        if r2.endswith("l") and word[-2] == "l":
            word = word[:-1]
        elif r2.endswith("e"):
            word = word[:-1]
        elif r1.endswith("e"):
            if len(word) >= 4 and (
                word[-2] in vowels
                or word[-2] in "wxY"
                or word[-3] not in vowels
                or word[-4] in vowels
            ):
                word = word[:-1]

        return word.replace("Y", "y")

    @staticmethod
    def _replace3(word, r1, r2, suffix, new, r2_short):
        """Replace ``suffix`` by ``new`` in the word and in each region
        long enough to hold it; a shorter R1 becomes "" and a shorter R2
        becomes ``r2_short`` (NLTK's per-rule choice)."""
        word = _suffix_replace(word, suffix, new)
        r1 = _suffix_replace(r1, suffix, new) if len(r1) >= len(suffix) else ""
        r2 = (_suffix_replace(r2, suffix, new) if len(r2) >= len(suffix)
              else r2_short)
        return word, r1, r2
