// Native batch SCC resolver — the C++ twin of the host Tarjan oracle.
//
// The port's copy of fantoch_tpu/native/tarjan.cpp.  The reference
// implements its execution-ordering walk in native code
// (fantoch_ps/src/executor/graph/tarjan.rs:99-319, Rust); the port keeps
// the batched kernels (fantoch_tpu_torch/ops/graph_resolve.py) as the hot
// path and this C++ resolver as the host route that
// ``Config.host_native_resolver=True`` selects for the batched graph
// executor.  Exact same output contract as the Python oracle
// (fantoch_tpu_torch/executor/graph/tarjan.py):
//
//   * members of one SCC are contiguous in the output and sorted by dot;
//   * an SCC follows every SCC it depends on (reverse-topological pop
//     order of Tarjan on the dependency orientation);
//   * vertices reaching a MISSING dependency (dep == -2) are not emitted.
//
// Input: CSR adjacency over batch slots.  dep targets are slot indices,
// -1 = executed/none (pruned), -2 = missing (blocks the component).
//
// Build: fantoch_tpu_torch/native/__init__.py (g++ -O3 -shared into
// fantoch_tpu_torch/build/, atomic rename), loaded via ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int32_t kTerminal = -1;
constexpr int32_t kMissing = -2;

struct Frame {
    int32_t v;
    int32_t edge;  // next edge offset to visit
};

}  // namespace

extern "C" {

// Returns the number of emitted (ordered) vertices, or -1 on bad input.
//   n            — batch size
//   offsets      — int32[n + 1] CSR row offsets into targets
//   targets      — int32[offsets[n]] dep slots (or kTerminal / kMissing)
//   dot_key      — int64[n] packed (source << 32 | sequence), intra-SCC order
//   out_order    — int32[n] emitted execution order (slot indices)
//   out_scc_size — int32[n] SCC size per emitted *position* (repeated for
//                  each member; callers derive CHAIN_SIZE metrics from the
//                  leader positions where a new SCC starts)
int32_t fantoch_resolve_sccs(int32_t n, const int32_t* offsets,
                             const int32_t* targets, const int64_t* dot_key,
                             int32_t* out_order, int32_t* out_scc_size) {
    if (n < 0) return -1;
    // Tarjan bookkeeping
    std::vector<int32_t> index(n, -1);   // discovery id, -1 = unvisited
    std::vector<int32_t> low(n, 0);
    std::vector<char> on_stack(n, 0);
    std::vector<char> blocked(n, 0);     // reaches a missing dependency
    std::vector<int32_t> stack;          // tarjan component stack
    std::vector<Frame> dfs;              // explicit DFS stack
    std::vector<std::vector<int32_t>> sccs;
    int32_t next_id = 0;

    stack.reserve(64);
    dfs.reserve(64);

    for (int32_t root = 0; root < n; ++root) {
        if (index[root] != -1) continue;
        dfs.push_back({root, offsets[root]});
        index[root] = low[root] = next_id++;
        on_stack[root] = 1;
        stack.push_back(root);

        while (!dfs.empty()) {
            Frame& f = dfs.back();
            const int32_t v = f.v;
            if (f.edge < offsets[v + 1]) {
                const int32_t w = targets[f.edge++];
                if (w == kTerminal) continue;
                if (w == kMissing) {
                    blocked[v] = 1;
                    continue;
                }
                if (w < 0 || w >= n) return -1;
                if (index[w] == -1) {
                    index[w] = low[w] = next_id++;
                    on_stack[w] = 1;
                    stack.push_back(w);
                    dfs.push_back({w, offsets[w]});
                } else if (on_stack[w]) {
                    low[v] = std::min(low[v], index[w]);
                } else if (blocked[w]) {
                    // finished component that reaches a missing dep:
                    // poisoning propagates to every dependent
                    blocked[v] = 1;
                }
            } else {
                dfs.pop_back();
                if (!dfs.empty()) {
                    const int32_t parent = dfs.back().v;
                    low[parent] = std::min(low[parent], low[v]);
                    if (blocked[v]) blocked[parent] = 1;
                }
                if (low[v] == index[v]) {
                    // pop the SCC; blocked-ness is shared by all members
                    // (they reach each other), so one flag decides
                    std::vector<int32_t> scc;
                    char scc_blocked = 0;
                    int32_t w;
                    do {
                        w = stack.back();
                        stack.pop_back();
                        on_stack[w] = 0;
                        scc_blocked |= blocked[w];
                        scc.push_back(w);
                    } while (w != v);
                    if (scc_blocked) {
                        for (int32_t m : scc) blocked[m] = 1;
                    } else {
                        std::sort(scc.begin(), scc.end(),
                                  [&](int32_t a, int32_t b) {
                                      return dot_key[a] < dot_key[b];
                                  });
                        sccs.push_back(std::move(scc));
                    }
                }
            }
        }
    }

    // Tarjan pops SCCs in reverse topological order of the condensation
    // *along the dependency orientation*: a component is only rooted after
    // all components it depends on have been popped, so pop order itself
    // is a valid execution order.
    int32_t pos = 0;
    for (const auto& scc : sccs) {
        const int32_t size = static_cast<int32_t>(scc.size());
        for (int32_t m : scc) {
            out_order[pos] = m;
            out_scc_size[pos] = size;
            ++pos;
        }
    }
    return pos;
}

}  // extern "C"
