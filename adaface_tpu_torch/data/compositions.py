"""Compositional prompt sampler.

Counterpart of `adaface_tpu/data/compositions.py`, the same numpy code, so
that both packages sample the same prompts from one RandomState. Functional
equivalent of `ldm/data/compositions.py`: uniformly samples an
action/dress/location phrase family, expands one concrete phrase, and
decorates it with probabilistic style/shot/lighting/art-by/background/time
modifiers using the reference's probability scheme (style 30/20/50 for
none/photorealistic/1-2 styles; shot 25%; background 60%; art-by 25%; time
25%; lighting always on).

Phrase inventories are our own (category-equivalent, DreamBooth-protocol
locations retained); templated options replace the reference's `exrex`
regex expansion — no regex dependency.
"""

from __future__ import annotations

import numpy as np

# (template, options) pairs — one option is sampled and substituted
ANIMAL_ACTIONS = [
    ("doing {}", ["yoga", "a workout", "some gardening", "chores", "makeup"]),
    ("carrying a {}", ["backpack", "bouquet", "puppy", "kitten", "guitar",
                       "teddy bear", "stack of books", "baby"]),
    ("holding a {}", ["coffee cup", "book", "flower", "sign", "camera",
                      "pen", "kite", "mushroom", "piece of fruit", "cat",
                      "dog", "baby", "stick"]),
    ("sitting {}", ["on a bench", "in an armchair", "on the floor",
                    "in a wheelchair", "on a swing"]),
    ("swimming {}", ["in a pool", "in the ocean", "in a lake",
                     "underwater among coral"]),
    ("pushing a {}", ["shopping cart", "stroller", "bicycle", "wheelbarrow"]),
    ("walking {}", ["in a forest", "along the beach", "through a park",
                    "down a city street", "under the stars", "on a trail"]),
    ("catching a {}", ["ball", "frisbee", "butterfly", "falling leaf"]),
    ("playing {}", ["the piano", "the guitar", "chess", "basketball",
                    "tennis", "a violin"]),
    ("riding a {}", ["bicycle", "horse", "skateboard", "scooter",
                     "motorcycle", "rowboat"]),
    ("{} a {}", [  # two-slot: verb + companion
        "hugging|kissing|holding", "puppy|kitten|baby"]),
    ("standing {}", ["beside a tree", "next to a vintage car", "in a stream",
                     "on a rooftop", "on a wooden box"]),
    ("drinking {}", ["a cup of tea", "a glass of juice", "a smoothie",
                     "a bottle of water"]),
    ("eating {}", ["a sandwich", "ice cream", "a slice of pizza", "noodles",
                   "a bowl of soup", "sushi", "a taco"]),
]

ANIMAL_DRESSES = [
    ("wearing a {}", ["space suit", "chef outfit", "superhero costume",
                      "tuxedo", "ski jacket", "baseball cap", "knight armor"]),
    ("wearing {}", ["a red beanie", "a santa hat", "a striped scarf",
                    "round glasses", "a yellow raincoat", "a flowing green robe",
                    "a martial arts uniform"]),
    ("in a {}", ["firefighter outfit", "police uniform", "wizard robe",
                 "elegant dress", "business suit", "pirate costume"]),
]

STATIC_ACTIONS = [
    ("leaning {}", ["against a brick wall", "on a railing", "against a tree",
                    "on the hood of a car"]),
    ("flying {}", ["through clouds", "over the city", "across a sunset sky",
                   "through outer space", "above the sea"]),
    ("on {}", ["a train platform", "a busy street", "a rooftop terrace",
               "an escalator", "a grassy hill", "a sailboat"]),
    ("in {}", ["a cozy cafe", "a classroom", "a concert hall", "a gym",
               "an old library", "a sunlit park", "a wedding ceremony"]),
    ("in {}", ["Tokyo", "Paris", "New York", "Venice", "Kyoto"]),
    ("at {}", ["the beach", "a farmers market", "a theme park", "a museum",
               "a mountain summit", "a lakeside dock"]),
    ("made of {}", ["brushed metal", "carved marble", "blown glass",
                    "woven wicker", "cast bronze", "clear ice"]),
    # DreamBooth evaluation-protocol locations
    ("{}", ["in the jungle", "in the snow", "on a cobblestone street"]),
    ("on top of {}", ["pink fabric", "a wooden floor",
                      "green grass with sunflowers around it",
                      "the sidewalk in a crowded street", "a dirt road",
                      "a white rug"]),
]

STATIC_APPEARANCES = [
    ("that is {}", ["glossy", "weathered", "translucent", "dew-covered"]),
]

SHOTS = ["full body shot", "medium shot", "front view"]

STYLES = [
    "watercolor painting", "oil painting", "charcoal sketch", "comic book art",
    "anime illustration", "pixel art", "low poly render", "clay sculpture",
    "stained glass", "art nouveau poster", "ukiyo-e print", "vaporwave",
    "cel-shaded animation", "storybook illustration", "graffiti mural",
    "paper cutout collage", "isometric 3d render", "pop art print",
    "impressionist painting", "cubist portrait", "gothic etching",
    "cinematic concept art", "studio photography", "volumetric render",
    "dreamlike digital painting", "retro-futurist poster", "linocut print",
]

TIMES = ["futuristic", "modern", "ancient", "antique", "retro",
         "old-fashioned", "youthful"]

LIGHTS = ["golden hour light", "moonlight", "candlelight", "neon glow",
          "soft window light", "dramatic rim light", "overcast light",
          "stage spotlights", "dappled sunlight", "bioluminescent glow"]

ARTISTS = ["a renowned concept artist", "a studio ghibli animator",
           "a national geographic photographer", "a renaissance master",
           "a modern street artist", "a children's book illustrator"]

BACKGROUNDS = [
    "a beach", "a mountain range", "a wheat field", "a castle courtyard",
    "a rainy city street", "a library", "a greenhouse", "a desert at dusk",
    "a harbor", "the northern lights", "a bamboo forest", "a train station",
    "cherry blossoms", "a snowy village", "an art gallery",
]


def _expand(template: str, options: list[str], rng: np.random.RandomState) -> str:
    if "|" in options[0] and template.count("{}") == 2:
        parts = [rng.choice(o.split("|")) for o in options]
        return template.format(*parts)
    return template.format(rng.choice(options))


def sample_compositions(
    n: int, subj_type: str = "animal", rng: np.random.RandomState | None = None
) -> tuple[list[str], list[str]]:
    """→ (compos_partial_prompts, prompt_modifiers), reference signature
    (`compositions.py:96-180`)."""
    rng = rng or np.random.RandomState()
    if subj_type == "animal":
        families = STATIC_ACTIONS + ANIMAL_ACTIONS + ANIMAL_DRESSES
    elif subj_type == "object":
        families = STATIC_ACTIONS + STATIC_APPEARANCES
    else:
        raise ValueError(f"unknown subject type '{subj_type}'")

    prompts, modifiers = [], []
    for _ in range(n):
        tmpl, opts = families[rng.choice(len(families))]
        composition = _expand(tmpl, opts, rng)

        has_style = rng.choice([0, 1, 2], p=[0.3, 0.2, 0.5])
        if has_style == 2:
            k = rng.choice([1, 2])
            style = " and ".join(rng.choice(STYLES, size=k, replace=False))
        elif has_style == 1:
            style = "photorealistic"
        else:
            style = ""

        shot = rng.choice(SHOTS) if rng.rand() < 0.25 else ""
        if rng.rand() < 0.25:
            k = rng.choice([1, 2, 3])
            art_by = "art by " + " and ".join(
                rng.choice(ARTISTS, size=k, replace=False))
        else:
            art_by = ""
        background = (f"with {rng.choice(BACKGROUNDS)} as background"
                      if rng.rand() < 0.6 else "")
        time = rng.choice(TIMES) if rng.rand() < 0.25 else ""
        light = "with " + rng.choice(LIGHTS)  # lighting always on

        modifier = ", ".join(s for s in [time, style, shot, light, art_by] if s)
        prompts.append(", ".join(s for s in [composition, background] if s))
        modifiers.append(modifier)
    return prompts, modifiers
