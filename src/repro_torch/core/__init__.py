from .agm import agm_bound, fractional_edge_cover
from .binary_join import BinaryJoin, JoinBlowup, binary_join_count
from .device_graph import GraphDB, HybridGraphDB
from .engine import (ENGINES, count, execute, execute_stats, make_engine,
                     pick_engine)
from .gao import choose_gao
from .hybrid import HybridJoin, hybrid_count
from .hypergraph import Hypergraph, all_neos, is_beta_acyclic, is_neo
from .lftj_ref import LFTJ, lftj_count
from .minesweeper_ref import Minesweeper, minesweeper_count
from .plan import (GraphStats, HybridPlan, JoinPlan, LevelPlan,
                   compile_levels, executor_geometry)
from .planner import (PlanCache, candidate_gaos, candidate_plans,
                      choose_level_layouts, decompose_hybrid,
                      estimate_vlftj_cost, plan_query)
from .query import (PAPER_QUERIES, Atom, LessThan, Query, clique, comb,
                    cycle, get_query, lollipop, parse, path, tree)
from .relation import Database, Relation
from .vlftj import VLFTJ, vlftj_count
from .yannakakis import (CountingYannakakis, NotTreeShaped, variable_tree,
                         yannakakis_count)

__all__ = [
    "agm_bound", "fractional_edge_cover", "BinaryJoin", "JoinBlowup",
    "binary_join_count", "GraphDB", "HybridGraphDB",
    "ENGINES", "count", "execute", "execute_stats", "make_engine",
    "pick_engine", "choose_gao", "HybridJoin", "hybrid_count", "Hypergraph",
    "all_neos", "is_beta_acyclic", "is_neo", "LFTJ", "lftj_count",
    "Minesweeper", "minesweeper_count", "GraphStats", "HybridPlan",
    "JoinPlan", "LevelPlan", "compile_levels", "executor_geometry",
    "PlanCache", "candidate_gaos", "candidate_plans", "choose_level_layouts",
    "decompose_hybrid", "estimate_vlftj_cost", "plan_query",
    "PAPER_QUERIES", "Atom", "LessThan", "Query", "clique", "comb", "cycle",
    "get_query", "lollipop", "parse", "path", "tree", "Database",
    "Relation", "VLFTJ", "vlftj_count", "CountingYannakakis",
    "NotTreeShaped", "variable_tree", "yannakakis_count",
]
