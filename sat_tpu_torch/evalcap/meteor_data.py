"""Data tables for the METEOR 1.5 scorer (``evalcap.meteor``) — the
port's copy of ``sat_tpu.evalcap.meteor_data``, table for table, so both
packages score with the same resources.

METEOR 1.5 ships two English resources that neither package bundles:

* ``function.words`` — words with relative corpus frequency > 1e-3,
  used for the δ content/function discount.  Reproduced here as a
  curated list of English closed-class words (articles, pronouns,
  prepositions, conjunctions, auxiliaries, particles, high-frequency
  adverbs) — the same population the frequency criterion selects.
* WordNet synsets for the synonym match stage.  Reproduced as a compact
  exact-match synonym table: groups of words treated as synonymous.
  Curated for general English with extra coverage of the COCO caption
  domain (scene/object/action vocabulary).  This is a subset of WordNet;
  divergence is documented in ``evalcap.meteor``.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Set

# ---------------------------------------------------------------------------
# function words (METEOR 1.5 function.words equivalent)
# ---------------------------------------------------------------------------

FUNCTION_WORDS: FrozenSet[str] = frozenset(
    """
    a an the this that these those some any each every either neither
    no such own same other another both all few many much more most
    several certain various
    i me my mine myself we us our ours ourselves you your yours yourself
    yourselves he him his himself she her hers herself it its itself
    they them their theirs themselves one ones who whom whose which what
    whatever whoever whichever something anything nothing everything
    someone anyone everyone somebody anybody nobody everybody
    am is are was were be been being do does did doing done have has had
    having will would shall should may might must can could ought need
    dare used
    and or but nor so yet for because although though while whereas if
    unless until since when whenever where wherever why how than whether
    as that lest once
    of in on at by to from with without within into onto upon about
    above below under over between among through during before after
    behind beside besides beyond against along across around down up
    off out near toward towards past via per amid amidst atop
    not never also just only very too quite rather almost nearly then
    there here now again ever still already perhaps maybe however
    therefore thus hence meanwhile moreover furthermore anyway instead
    else
     's 't n't 'll 're 've 'd 'm
    """.split()
)

# ---------------------------------------------------------------------------
# synonym groups (compact WordNet-synset stand-in, exact-match lookup)
# ---------------------------------------------------------------------------

_SYNONYM_GROUPS = [
    # --- general English ---
    "big large huge enormous giant gigantic massive",
    "small little tiny miniature petite",
    "quick fast rapid speedy swift",
    "slow sluggish unhurried",
    "happy glad joyful cheerful pleased delighted",
    "sad unhappy sorrowful gloomy",
    "angry mad furious irate",
    "pretty beautiful lovely gorgeous attractive handsome",
    "ugly hideous unattractive unsightly",
    "smart intelligent clever bright brainy",
    "stupid dumb foolish silly",
    "begin start commence initiate",
    "end finish conclude terminate stop cease",
    "buy purchase acquire",
    "sell vend",
    "speak talk converse chat",
    "say tell state utter",
    "look watch view observe see gaze stare",
    "hear listen",
    "walk stroll saunter amble wander",
    "run sprint dash jog race",
    "jump leap hop bound vault",
    "throw toss hurl fling pitch",
    "catch grab seize snatch capture",
    "hold grasp grip clutch",
    "carry tote haul lug transport",
    "pull tug drag yank tow",
    "push shove press",
    "eat consume devour dine munch",
    "drink sip gulp",
    "cook prepare bake",
    "cut slice chop carve dice",
    "make create build construct produce fabricate",
    "break shatter smash crack fracture",
    "fix repair mend restore",
    "clean wash scrub rinse",
    "close shut",
    "open unlock",
    "give provide supply furnish grant",
    "get obtain receive gain",
    "keep retain preserve maintain",
    "leave depart exit",
    "arrive come reach",
    "show display exhibit present demonstrate",
    "hide conceal cover",
    "find discover locate spot",
    "lose misplace",
    "help assist aid support",
    "like enjoy love adore fancy",
    "hate dislike despise loathe",
    "want desire wish crave",
    "need require",
    "think ponder contemplate consider reflect",
    "know understand comprehend realize",
    "remember recall recollect",
    "forget overlook",
    "choose select pick elect",
    "answer reply respond",
    "ask inquire question query",
    "shout yell scream holler",
    "whisper murmur mutter",
    "laugh giggle chuckle",
    "cry weep sob",
    "smile grin beam",
    "sleep doze nap slumber snooze rest",
    "wake awaken rouse",
    "sit perch",
    "stand rise",
    "fall tumble drop plunge",
    "climb ascend scale mount",
    "descend dismount",
    "fly soar glide hover",
    "swim wade paddle",
    "travel journey trek voyage",
    "drive steer pilot operate",
    "ride mount",
    "play frolic romp",
    "work labor toil",
    "study learn",
    "teach instruct educate train coach",
    "write compose pen scribble jot",
    "read peruse",
    "draw sketch illustrate doodle",
    "paint color",
    "sing chant croon",
    "dance twirl",
    "move shift relocate",
    "turn rotate spin twist revolve pivot",
    "shake tremble shiver quiver wobble",
    "touch feel",
    "smell sniff scent",
    "taste sample savor",
    "wear don sport",
    "begin beginning",
    "nice pleasant agreeable enjoyable",
    "bad terrible awful horrible dreadful poor lousy",
    "good great excellent fine wonderful superb fantastic terrific",
    "cold chilly frigid freezing frosty cool",
    "hot warm heated scorching sweltering",
    "wet damp moist soggy soaked drenched",
    "dry arid parched",
    "new fresh novel recent modern",
    "old ancient aged elderly antique vintage",
    "young youthful juvenile",
    "tall high lofty towering",
    "short low",
    "wide broad spacious vast expansive",
    "narrow slim thin slender skinny",
    "thick dense",
    "heavy weighty hefty",
    "light lightweight",
    "hard difficult tough challenging",
    "easy simple effortless",
    "loud noisy deafening",
    "quiet silent hushed still",
    "bright brilliant radiant luminous vivid shiny gleaming",
    "dark dim shadowy gloomy murky",
    "clean spotless tidy neat",
    "dirty filthy grimy muddy soiled messy",
    "full crowded packed stuffed",
    "empty vacant bare hollow",
    "strange odd weird peculiar unusual curious bizarre",
    "normal ordinary usual typical common regular",
    "important significant crucial vital essential",
    "funny amusing humorous comical hilarious",
    "scary frightening terrifying fearsome creepy spooky",
    "dangerous hazardous risky perilous unsafe",
    "safe secure protected",
    "rich wealthy affluent",
    "poor impoverished needy",
    "famous renowned celebrated noted",
    "tired exhausted weary fatigued sleepy drowsy",
    "hungry starving famished",
    "real genuine authentic actual true",
    "fake false counterfeit phony artificial",
    "whole entire complete total full",
    "part portion piece segment section fragment slice",
    "group bunch cluster crowd gathering collection herd flock pack",
    "pair couple duo twosome",
    "lots many numerous plenty several",
    "top summit peak crest",
    "bottom base foot",
    "middle center midst",
    "edge border rim margin brink verge",
    "side flank",
    "front fore",
    "back rear behind",
    "place location spot site position area region zone",
    "road street avenue boulevard lane highway roadway",
    "path trail track walkway footpath sidewalk pavement",
    "house home residence dwelling abode",
    "building structure edifice",
    "store shop market boutique",
    "restaurant diner cafe eatery bistro",
    "kitchen galley",
    "bathroom restroom washroom lavatory toilet",
    "bedroom chamber",
    "car automobile auto vehicle sedan",
    "truck lorry pickup",
    "bicycle bike cycle",
    "motorcycle motorbike moped scooter",
    "bus coach minibus",
    "train locomotive railcar",
    "airplane plane aircraft jet airliner",
    "boat ship vessel sailboat yacht ferry canoe kayak",
    "child kid youngster toddler tot",
    "children kids youngsters toddlers",
    "baby infant newborn",
    "boy lad",
    "girl lass",
    "man gentleman guy fellow male dude",
    "men gentlemen guys males fellows dudes",
    "woman lady female gal",
    "women ladies females gals",
    "person individual human",
    "people persons individuals humans folks",
    "friend pal buddy companion mate",
    "doctor physician surgeon",
    "police officer cop policeman constable",
    "photo photograph picture image snapshot",
    "television tv telly",
    "phone telephone cellphone smartphone mobile",
    "computer laptop pc",
    "couch sofa settee loveseat",
    "chair seat stool",
    "table desk counter countertop",
    "bag sack purse handbag satchel backpack knapsack",
    "cup mug glass tumbler",
    "plate dish platter",
    "bowl basin",
    "bottle flask jug",
    "box container carton crate bin",
    "garbage trash rubbish waste refuse litter",
    "gift present",
    "money cash currency",
    "clothes clothing garments apparel attire outfit",
    "shirt blouse tee tshirt",
    "pants trousers slacks jeans",
    "coat jacket blazer parka overcoat",
    "hat cap beanie bonnet helmet",
    "shoe boot sneaker sandal slipper",
    "rock stone boulder pebble",
    "hill mound knoll slope",
    "mountain peak mount",
    "forest woods woodland grove",
    "tree sapling",
    "grass lawn turf",
    "flower blossom bloom",
    "river stream creek brook",
    "lake pond lagoon reservoir",
    "ocean sea",
    "beach shore coast seashore seaside",
    "rain shower drizzle downpour",
    "snow sleet slush",
    "wind breeze gust gale",
    "storm tempest thunderstorm",
    "fire blaze flame inferno",
    "smoke fumes",
    "sun sunshine sunlight",
    "sky heavens",
    "cloud clouds",
    "night nighttime evening dusk",
    "morning dawn daybreak sunrise",
    "day daytime",
    "dog puppy pup canine hound pooch",
    "cat kitten feline kitty",
    "horse pony stallion mare steed equine",
    "cow cattle bull ox bovine calf",
    "sheep lamb ewe ram",
    "goat kid billy",
    "pig hog swine boar piglet",
    "bird fowl",
    "chicken hen rooster",
    "duck duckling",
    "fish trout salmon",
    "bear cub",
    "elephant pachyderm",
    "monkey ape primate chimp chimpanzee",
    "lion lioness",
    "tiger tigress",
    "rabbit bunny hare",
    "mouse rodent rat",
    "snake serpent",
    "insect bug",
    "butterfly moth",
    "bee wasp hornet",
    "meal dinner supper feast lunch breakfast brunch",
    "food cuisine fare grub",
    "bread loaf baguette toast",
    "cake pastry dessert",
    "candy sweets confection",
    "meat beef pork steak",
    "vegetable veggie produce",
    "fruit produce",
    "juice beverage drink",
    "coffee espresso latte cappuccino",
    "laptop notebook",
    "ball sphere orb",
    "toy plaything",
    "game match contest competition",
    "sport athletics",
    "team squad crew",
    "player athlete competitor",
    "field pitch meadow pasture paddock",
    "park playground",
    "garden yard backyard",
    "fence railing barrier",
    "wall partition",
    "door doorway entrance entry gateway gate",
    "window pane",
    "roof rooftop",
    "floor ground",
    "stairs staircase stairway steps",
    "bridge overpass viaduct",
    "tower spire",
    "church chapel cathedral",
    "school academy",
    "hospital clinic infirmary",
    "airport airfield",
    "station depot terminal",
    "city town metropolis municipality",
    "village hamlet",
    "country nation land",
    "world earth globe",
]

SYNONYM_GROUPS = tuple(tuple(g.split()) for g in _SYNONYM_GROUPS)


def build_synonym_index() -> Dict[str, Set[int]]:
    """word → set of group ids.  Two words are synonyms iff their id sets
    intersect (exact-match synset semantics)."""
    index: Dict[str, Set[int]] = {}
    for gid, group in enumerate(SYNONYM_GROUPS):
        for w in group:
            index.setdefault(w, set()).add(gid)
    return index


# ---------------------------------------------------------------------------
# paraphrase groups (compact stand-in for METEOR 1.5's en paraphrase table)
# ---------------------------------------------------------------------------
# The jar's paraphrase stage (weight 0.6) matches multi-word phrase spans
# via an ~80MB table extracted from bilingual pivoting, which neither
# package bundles.  This compact curated table keeps
# the STAGE faithful (span-level alignment mechanics, weight, chunk
# accounting) with coverage focused on English caption phrasing; phrases
# within a group are mutually substitutable.  Divergence (table size) is
# documented in meteor.py.

_PARAPHRASE_GROUPS = [
    ("next to", "beside", "alongside", "adjacent to", "close to", "near"),
    ("in front of", "before", "ahead of"),
    ("on top of", "atop", "upon", "on"),
    ("a number of", "a group of", "a bunch of", "several", "many", "a lot of", "lots of"),
    ("a couple of", "a pair of", "two"),
    ("is sitting", "sits", "is seated"),
    ("is standing", "stands"),
    ("is riding", "rides"),
    ("is holding", "holds", "is carrying", "carries"),
    ("is wearing", "wears", "is dressed in", "dressed in"),
    ("is eating", "eats", "is consuming"),
    ("is walking", "walks", "is strolling"),
    ("is running", "runs"),
    ("is playing", "plays"),
    ("is looking at", "looks at", "is watching", "watches", "is viewing"),
    ("is flying", "flies", "is soaring"),
    ("is jumping", "jumps", "is leaping"),
    ("is lying", "lies", "is laying", "lays"),
    ("gets ready to", "prepares to", "is about to", "is preparing to"),
    ("in the middle of", "in the center of", "amid", "amidst"),
    ("at the top of", "atop"),
    ("at the bottom of", "below", "beneath", "under", "underneath"),
    ("on the side of", "beside"),
    ("a man", "a person", "a guy", "a gentleman", "someone"),
    ("a woman", "a person", "a lady", "someone"),
    ("a child", "a kid", "a youngster", "a little one"),
    ("a large", "a big", "a huge"),
    ("a small", "a little", "a tiny"),
    ("a lot", "plenty", "a great deal"),
    ("each other", "one another"),
    ("in order to", "to", "so as to"),
    ("because of", "due to", "owing to", "on account of"),
    ("a few", "some", "a couple"),
    ("right now", "currently", "at the moment", "presently"),
    ("as well", "also", "too", "in addition"),
    ("kind of", "sort of", "type of"),
    ("is filled with", "is full of", "contains"),
    ("is covered in", "is covered with"),
    ("made of", "made from", "composed of", "constructed of"),
    ("a photo of", "a picture of", "an image of", "a photograph of"),
    ("black and white", "monochrome"),
    ("fire hydrant", "hydrant"),
    ("stop sign", "traffic sign"),
    ("traffic light", "stoplight", "traffic signal"),
    ("cell phone", "cellphone", "mobile phone", "phone"),
    ("hot dog", "hotdog", "frankfurter"),
    ("teddy bear", "stuffed bear", "stuffed animal"),
    ("parking lot", "car park"),
    ("train station", "railway station", "depot"),
    ("living room", "lounge", "sitting room"),
    ("dining table", "dinner table", "table"),
    ("front of", "ahead of"),
    ("group of people", "crowd", "crowd of people", "people"),
    ("body of water", "water", "lake", "pond"),
    ("up close", "close up", "closeup"),
    ("gets on", "boards", "mounts"),
    ("gets off", "dismounts", "exits"),
    ("takes off", "departs", "lifts off"),
    ("comes in", "enters", "arrives"),
    ("goes out", "exits", "leaves"),
]

PARAPHRASE_GROUPS = tuple(_PARAPHRASE_GROUPS)

MAX_PARAPHRASE_LEN = max(
    len(p.split()) for g in PARAPHRASE_GROUPS for p in g
)


def build_paraphrase_index() -> Dict[str, Set[int]]:
    """phrase (space-joined words) → set of group ids.  Two spans are
    paraphrases iff their id sets intersect, mirroring the synonym
    semantics at phrase granularity."""
    index: Dict[str, Set[int]] = {}
    for gid, group in enumerate(PARAPHRASE_GROUPS):
        for p in group:
            index.setdefault(p, set()).add(gid)
    return index
