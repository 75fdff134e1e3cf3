"""Curated high-frequency English pronunciation lexicon (a copy of the JAX
package's ``text/lexicon.py``).

The reference's English path rides the `g2p` library's mappings
(fs2/dataset.py:155-174); a rule-only engine systematically mispronounces
irregular English ("this" -> unvoiced th, "one" -> /oʊn/, no vowel
reduction, no stress). The repository ships no CMUdict, so this is a
hand-curated lexicon of the highest-frequency English words — function
words, irregular spellings, and common content words — consulted BEFORE
the spelling rules in `english_g2p`; rules remain the OOV fallback.

Conventions (General American):
 - entries are space-separated IPA phone tokens from the engine's
   inventory (g2p.IPA_PHONES)
 - "ˈ" is its own token immediately before the stressed vowel of
   polysyllabic words; monosyllables carry no mark
 - reduced vowels use "ə"; stressed r-colored vowels use "ɝ"
 - keys are lowercase with apostrophes removed (the tokenizer strips
   them), so "don't" looks up "dont"
"""

from __future__ import annotations

# fmt: off
ENGLISH_LEXICON: dict[str, str] = {
    # ---- function words / pronouns / auxiliaries ----
    "the": "ð ə", "of": "ʌ v", "to": "t u", "and": "æ n d", "a": "ə",
    "in": "ɪ n", "is": "ɪ z", "was": "w ʌ z", "he": "h i", "for": "f ɔ ɹ",
    "it": "ɪ t", "with": "w ɪ ð", "as": "æ z", "his": "h ɪ z", "on": "ɑ n",
    "be": "b i", "at": "æ t", "by": "b aɪ", "i": "aɪ", "this": "ð ɪ s",
    "had": "h æ d", "not": "n ɑ t", "are": "ɑ ɹ", "but": "b ʌ t",
    "from": "f ɹ ʌ m", "or": "ɔ ɹ", "have": "h æ v", "an": "æ n",
    "they": "ð eɪ", "which": "w ɪ tʃ", "one": "w ʌ n", "you": "j u",
    "were": "w ɝ", "her": "h ɝ", "all": "ɔ l", "she": "ʃ i",
    "there": "ð ɛ ɹ", "would": "w ʊ d", "their": "ð ɛ ɹ", "we": "w i",
    "him": "h ɪ m", "been": "b ɪ n", "has": "h æ z", "when": "w ɛ n",
    "who": "h u", "will": "w ɪ l", "more": "m ɔ ɹ", "no": "n oʊ",
    "if": "ɪ f", "out": "aʊ t", "so": "s oʊ", "said": "s ɛ d",
    "what": "w ʌ t", "up": "ʌ p", "its": "ɪ t s", "about": "ə b ˈaʊ t",
    "into": "ˈɪ n t u", "than": "ð æ n", "them": "ð ɛ m", "can": "k æ n",
    "only": "ˈoʊ n l i", "other": "ˈʌ ð ɝ", "new": "n u", "some": "s ʌ m",
    "could": "k ʊ d", "time": "t aɪ m", "these": "ð i z", "two": "t u",
    "may": "m eɪ", "then": "ð ɛ n", "do": "d u", "first": "f ɝ s t",
    "any": "ˈɛ n i", "my": "m aɪ", "now": "n aʊ", "such": "s ʌ tʃ",
    "like": "l aɪ k", "our": "aʊ ɹ", "over": "ˈoʊ v ɝ", "man": "m æ n",
    "me": "m i", "even": "ˈi v ə n", "most": "m oʊ s t", "made": "m eɪ d",
    "after": "ˈæ f t ɝ", "also": "ˈɔ l s oʊ", "did": "d ɪ d",
    "many": "ˈm ɛ n i", "before": "b ɪ f ˈɔ ɹ", "must": "m ʌ s t",
    "through": "θ ɹ u", "years": "j ɪ ɹ z", "where": "w ɛ ɹ",
    "much": "m ʌ tʃ", "your": "j ɔ ɹ", "way": "w eɪ", "well": "w ɛ l",
    "down": "d aʊ n", "should": "ʃ ʊ d", "because": "b ɪ k ˈʌ z",
    "each": "i tʃ", "just": "dʒ ʌ s t", "those": "ð oʊ z",
    "people": "ˈp i p ə l", "how": "h aʊ", "too": "t u",
    "little": "ˈl ɪ t ə l", "good": "ɡ ʊ d", "very": "ˈv ɛ ɹ i",
    "make": "m eɪ k", "world": "w ɝ l d", "still": "s t ɪ l",
    "own": "oʊ n", "see": "s i", "men": "m ɛ n", "work": "w ɝ k",
    "long": "l ɔ ŋ", "here": "h ɪ ɹ", "get": "ɡ ɛ t", "both": "b oʊ θ",
    "between": "b ɪ t w ˈi n", "life": "l aɪ f", "being": "ˈb i ɪ ŋ",
    "under": "ˈʌ n d ɝ", "never": "ˈn ɛ v ɝ", "day": "d eɪ",
    "same": "s eɪ m", "another": "ə n ˈʌ ð ɝ", "know": "n oʊ",
    "while": "w aɪ l", "last": "l æ s t", "might": "m aɪ t", "us": "ʌ s",
    "great": "ɡ ɹ eɪ t", "old": "oʊ l d", "year": "j ɪ ɹ", "off": "ɔ f",
    "come": "k ʌ m", "since": "s ɪ n s", "against": "ə ɡ ˈɛ n s t",
    "go": "ɡ oʊ", "came": "k eɪ m", "right": "ɹ aɪ t", "used": "j u z d",
    "take": "t eɪ k", "three": "θ ɹ i", "himself": "h ɪ m s ˈɛ l f",
    "few": "f j u", "house": "h aʊ s", "use": "j u z", "during": "ˈd ʊ ɹ ɪ ŋ",
    "without": "w ɪ ð ˈaʊ t", "again": "ə ɡ ˈɛ n", "place": "p l eɪ s",
    "around": "ə ɹ ˈaʊ n d", "however": "h aʊ ˈɛ v ɝ", "home": "h oʊ m",
    "small": "s m ɔ l", "found": "f aʊ n d", "mrs": "ˈm ɪ s ɪ z",
    "thought": "θ ɔ t", "went": "w ɛ n t", "say": "s eɪ", "part": "p ɑ ɹ t",
    "once": "w ʌ n s", "general": "ˈdʒ ɛ n ɝ ə l", "high": "h aɪ",
    "upon": "ə p ˈɑ n", "school": "s k u l", "every": "ˈɛ v ɹ i",
    "dont": "d oʊ n t", "does": "d ʌ z", "got": "ɡ ɑ t",
    "united": "j u n ˈaɪ t ɪ d", "left": "l ɛ f t", "number": "ˈn ʌ m b ɝ",
    "course": "k ɔ ɹ s", "war": "w ɔ ɹ", "until": "ʌ n t ˈɪ l",
    "always": "ˈɔ l w eɪ z", "away": "ə w ˈeɪ", "something": "ˈs ʌ m θ ɪ ŋ",
    "fact": "f æ k t", "though": "ð oʊ", "water": "ˈw ɔ t ɝ",
    "less": "l ɛ s", "public": "ˈp ʌ b l ɪ k", "put": "p ʊ t",
    "think": "θ ɪ ŋ k", "almost": "ˈɔ l m oʊ s t", "hand": "h æ n d",
    "enough": "ɪ n ˈʌ f", "far": "f ɑ ɹ", "took": "t ʊ k",
    "head": "h ɛ d", "yet": "j ɛ t", "government": "ˈɡ ʌ v ɝ n m ə n t",
    "system": "ˈs ɪ s t ə m", "better": "ˈb ɛ t ɝ", "set": "s ɛ t",
    "told": "t oʊ l d", "nothing": "ˈn ʌ θ ɪ ŋ", "night": "n aɪ t",
    "end": "ɛ n d", "why": "w aɪ", "called": "k ɔ l d", "didnt": "ˈd ɪ d ə n t",
    "eyes": "aɪ z", "find": "f aɪ n d", "going": "ˈɡ oʊ ɪ ŋ",
    "look": "l ʊ k", "asked": "æ s k t", "later": "ˈl eɪ t ɝ",
    "knew": "n u", "point": "p ɔɪ n t", "next": "n ɛ k s t",
    "city": "ˈs ɪ t i", "business": "ˈb ɪ z n ɪ s", "give": "ɡ ɪ v",
    "group": "ɡ ɹ u p", "toward": "t ɔ ɹ d", "young": "j ʌ ŋ",
    "days": "d eɪ z", "let": "l ɛ t", "room": "ɹ u m",
    "within": "w ɪ ð ˈɪ n", "children": "ˈtʃ ɪ l d ɹ ə n", "side": "s aɪ d",
    "social": "ˈs oʊ ʃ ə l", "given": "ˈɡ ɪ v ə n", "order": "ˈɔ ɹ d ɝ",
    "often": "ˈɔ f ə n", "national": "ˈn æ ʃ ə n ə l", "door": "d ɔ ɹ",
    "among": "ə m ˈʌ ŋ", "white": "w aɪ t", "best": "b ɛ s t",
    "turned": "t ɝ n d", "want": "w ɑ n t", "second": "ˈs ɛ k ə n d",
    "others": "ˈʌ ð ɝ z", "seemed": "s i m d", "face": "f eɪ s",
    "god": "ɡ ɑ d", "open": "ˈoʊ p ə n", "per": "p ɝ",
    "interest": "ˈɪ n t ɹ ɪ s t", "large": "l ɑ ɹ dʒ", "case": "k eɪ s",
    "things": "θ ɪ ŋ z", "felt": "f ɛ l t", "four": "f ɔ ɹ",
    "possible": "ˈp ɑ s ə b ə l", "early": "ˈɝ l i", "am": "æ m",
    "yes": "j ɛ s", "done": "d ʌ n",
    "whole": "h oʊ l", "power": "ˈp aʊ ɝ", "itself": "ɪ t s ˈɛ l f",
    "several": "ˈs ɛ v ɹ ə l", "present": "ˈp ɹ ɛ z ə n t",
    "anything": "ˈɛ n i θ ɪ ŋ", "week": "w i k", "question": "ˈk w ɛ s tʃ ə n",
    "keep": "k i p", "thing": "θ ɪ ŋ", "study": "ˈs t ʌ d i",
    "seen": "s i n", "family": "ˈf æ m ə l i", "whose": "h u z",
    "women": "ˈw ɪ m ɪ n", "woman": "ˈw ʊ m ə n", "boy": "b ɔɪ",
    "area": "ˈɛ ɹ i ə", "body": "ˈb ɑ d i", "moment": "ˈm oʊ m ə n t",
    "money": "ˈm ʌ n i", "mother": "ˈm ʌ ð ɝ", "father": "ˈf ɑ ð ɝ",
    "brother": "ˈb ɹ ʌ ð ɝ", "month": "m ʌ n θ", "front": "f ɹ ʌ n t",
    "son": "s ʌ n", "won": "w ʌ n", "none": "n ʌ n", "love": "l ʌ v",
    "move": "m u v", "prove": "p ɹ u v", "live": "l ɪ v",
    "having": "ˈh æ v ɪ ŋ", "heart": "h ɑ ɹ t", "earth": "ɝ θ",
    "learn": "l ɝ n", "word": "w ɝ d", "words": "w ɝ d z",
    "worse": "w ɝ s", "worth": "w ɝ θ", "watch": "w ɑ tʃ",
    "wash": "w ɑ ʃ", "walk": "w ɔ k", "talk": "t ɔ k", "half": "h æ f",
    "calm": "k ɑ m", "iron": "ˈaɪ ɝ n", "island": "ˈaɪ l ə n d",
    "answer": "ˈæ n s ɝ", "listen": "ˈl ɪ s ə n", "busy": "ˈb ɪ z i",
    "says": "s ɛ z", "pretty": "ˈp ɹ ɪ t i", "friend": "f ɹ ɛ n d",
    "eight": "eɪ t", "weight": "w eɪ t", "height": "h aɪ t",
    "either": "ˈi ð ɝ", "neither": "ˈn i ð ɝ", "rough": "ɹ ʌ f",
    "tough": "t ʌ f", "cough": "k ɔ f", "laugh": "l æ f",
    "daughter": "ˈd ɔ t ɝ", "bought": "b ɔ t", "brought": "b ɹ ɔ t",
    "caught": "k ɔ t", "taught": "t ɔ t", "heard": "h ɝ d",
    "sure": "ʃ ʊ ɹ", "sugar": "ˈʃ ʊ ɡ ɝ", "ocean": "ˈoʊ ʃ ə n",
    "machine": "m ə ʃ ˈi n", "stomach": "ˈs t ʌ m ə k", "ache": "eɪ k",
    "guess": "ɡ ɛ s", "guest": "ɡ ɛ s t", "build": "b ɪ l d",
    "built": "b ɪ l t", "buy": "b aɪ", "guy": "ɡ aɪ", "eye": "aɪ",
    "dead": "d ɛ d", "death": "d ɛ θ", "bread": "b ɹ ɛ d",
    "ready": "ˈɹ ɛ d i", "weather": "ˈw ɛ ð ɝ", "heavy": "ˈh ɛ v i",
    "measure": "ˈm ɛ ʒ ɝ", "pleasure": "ˈp l ɛ ʒ ɝ",
    "treasure": "ˈt ɹ ɛ ʒ ɝ", "usual": "ˈj u ʒ u ə l",
    "usually": "ˈj u ʒ u ə l i", "vision": "ˈv ɪ ʒ ə n",
    "decision": "d ɪ s ˈɪ ʒ ə n", "television": "ˈt ɛ l ə v ɪ ʒ ə n",
    "piece": "p i s", "field": "f i l d",
    "believe": "b ɪ l ˈi v", "receive": "ɹ ɪ s ˈi v",
    "minute": "ˈm ɪ n ɪ t", "beautiful": "ˈb j u t ɪ f ə l",
    "beauty": "ˈb j u t i", "idea": "aɪ d ˈi ə", "real": "ˈɹ i l",
    "really": "ˈɹ i l i",     # ---- common content words ----
    "voice": "v ɔɪ s", "speech": "s p i tʃ", "language": "ˈl æ ŋ ɡ w ɪ dʒ",
    "sound": "s aʊ n d", "music": "ˈm j u z ɪ k", "model": "ˈm ɑ d ə l",
    "text": "t ɛ k s t", "read": "ɹ i d", "reading": "ˈɹ i d ɪ ŋ",
    "book": "b ʊ k", "story": "ˈs t ɔ ɹ i", "example": "ɪ ɡ z ˈæ m p ə l",
    "learning": "ˈl ɝ n ɪ ŋ", "teacher": "ˈt i tʃ ɝ", "child": "tʃ aɪ l d",
    "morning": "ˈm ɔ ɹ n ɪ ŋ", "evening": "ˈi v n ɪ ŋ",
    "afternoon": "æ f t ɝ n ˈu n", "tomorrow": "t ə m ˈɑ ɹ oʊ",
    "yesterday": "ˈj ɛ s t ɝ d eɪ", "today": "t ə d ˈeɪ",
    "river": "ˈɹ ɪ v ɝ", "mountain": "ˈm aʊ n t ə n", "valley": "ˈv æ l i",
    "forest": "ˈf ɔ ɹ ɪ s t", "garden": "ˈɡ ɑ ɹ d ə n", "tree": "t ɹ i",
    "flower": "ˈf l aʊ ɝ", "bird": "b ɝ d", "horse": "h ɔ ɹ s",
    "winter": "ˈw ɪ n t ɝ", "summer": "ˈs ʌ m ɝ", "spring": "s p ɹ ɪ ŋ",
    "autumn": "ˈɔ t ə m", "wind": "w ɪ n d",
    "rain": "ɹ eɪ n", "snow": "s n oʊ", "cloud": "k l aʊ d",
    "light": "l aɪ t", "dark": "d ɑ ɹ k", "color": "ˈk ʌ l ɝ",
    "silver": "ˈs ɪ l v ɝ", "golden": "ˈɡ oʊ l d ə n", "green": "ɡ ɹ i n",
    "blue": "b l u", "red": "ɹ ɛ d", "black": "b l æ k",
    "bright": "b ɹ aɪ t", "quiet": "ˈk w aɪ ə t", "gentle": "ˈdʒ ɛ n t ə l",
    "cold": "k oʊ l d", "warm": "w ɔ ɹ m", "deep": "d i p",
    "wide": "w aɪ d", "east": "i s t", "west": "w ɛ s t",
    "north": "n ɔ ɹ θ", "south": "s aʊ θ", "harbor": "ˈh ɑ ɹ b ɝ",
    "shore": "ʃ ɔ ɹ", "stone": "s t oʊ n", "bridge": "b ɹ ɪ dʒ",
    "road": "ɹ oʊ d", "street": "s t ɹ i t", "town": "t aʊ n",
    "country": "ˈk ʌ n t ɹ i", "building": "ˈb ɪ l d ɪ ŋ",
    "window": "ˈw ɪ n d oʊ", "table": "ˈt eɪ b ə l", "chair": "tʃ ɛ ɹ",
    "paper": "ˈp eɪ p ɝ", "letter": "ˈl ɛ t ɝ", "picture": "ˈp ɪ k tʃ ɝ",
    "hello": "h ə l ˈoʊ", "goodbye": "ɡ ʊ d b ˈaɪ", "please": "p l i z",
    "thank": "θ æ ŋ k", "thanks": "θ æ ŋ k s", "welcome": "ˈw ɛ l k ə m",
    "quickstart": "ˈk w ɪ k s t ɑ ɹ t", "computer": "k ə m p j ˈu t ɝ",
    "science": "ˈs aɪ ə n s", "nature": "ˈn eɪ tʃ ɝ",
    "future": "ˈf j u tʃ ɝ",     "person": "ˈp ɝ s ə n", "human": "ˈh j u m ə n",
    "different": "ˈd ɪ f ɝ ə n t", "important": "ɪ m p ˈɔ ɹ t ə n t",
    "together": "t ə ɡ ˈɛ ð ɝ", "nobody": "ˈn oʊ b ɑ d i",
    "everyone": "ˈɛ v ɹ i w ʌ n", "everything": "ˈɛ v ɹ i θ ɪ ŋ",
    "already": "ɔ l ˈɹ ɛ d i", "perhaps": "p ɝ h ˈæ p s",
    "probably": "ˈp ɹ ɑ b ə b l i", "certainly": "ˈs ɝ t ə n l i",
    "suddenly": "ˈs ʌ d ə n l i", "finally": "ˈf aɪ n ə l i",
    "actually": "ˈæ k tʃ u ə l i", "especially": "ɪ s p ˈɛ ʃ ə l i",
}
# fmt: on

def lookup(word: str) -> list[str] | None:
    """Phone tokens for a lowercase apostrophe-stripped word, or None.

    A "ˈX" entry token is emitted as TWO tokens — the stress mark then the
    vowel — so the stress symbol is one inventory entry rather than a
    per-vowel symbol explosion."""
    entry = ENGLISH_LEXICON.get(word)
    if entry is None:
        return None
    out: list[str] = []
    for tok in entry.split(" "):
        if len(tok) > 1 and tok.startswith("ˈ"):
            out.append("ˈ")
            out.append(tok[1:])
        else:
            out.append(tok)
    return out
