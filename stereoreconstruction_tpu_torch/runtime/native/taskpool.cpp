// Native task runtime: worker thread pool with per-task progress and
// cooperative cancellation.
//
// Replaces the reference's Qt task machinery (gui/task.hpp:36-103 Task +
// NewTaskEvent; MainWindow::customEvent spawning one QThread per task,
// gui/mainwindow.cpp:1174-1198): tasks run on a fixed pool, publish integer
// progress (Task::progressUpdate) and poll a cancellation flag
// (Task::isCancelled), all lock-free via atomics.  Exposed as a C ABI for
// ctypes; Python callbacks run fine because ctypes re-acquires the GIL per
// call.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

typedef void (*task_fn)(void* ctx, int64_t task_id);

struct TaskState {
  std::atomic<int> progress{0};
  std::atomic<bool> cancelled{false};
  std::atomic<bool> done{false};
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<std::pair<int64_t, std::function<void()>>> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable cv_done;
  std::unordered_map<int64_t, TaskState*> tasks;
  std::atomic<int64_t> next_id{1};
  std::atomic<int> active{0};
  bool stopping = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] { run(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> l(mu);
      stopping = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
    for (auto& kv : tasks) delete kv.second;
  }

  void run() {
    for (;;) {
      std::pair<int64_t, std::function<void()>> job;
      {
        std::unique_lock<std::mutex> l(mu);
        cv.wait(l, [this] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
        ++active;
      }
      job.second();
      {
        std::lock_guard<std::mutex> l(mu);
        --active;
        auto it = tasks.find(job.first);
        if (it != tasks.end()) it->second->done.store(true);
      }
      cv_done.notify_all();
    }
  }

  int64_t submit(task_fn fn, void* ctx) {
    int64_t id = next_id++;
    auto* st = new TaskState();
    {
      std::lock_guard<std::mutex> l(mu);
      tasks[id] = st;
      queue.emplace_back(id, [fn, ctx, id] { fn(ctx, id); });
    }
    cv.notify_one();
    return id;
  }

  TaskState* state(int64_t id) {
    std::lock_guard<std::mutex> l(mu);
    auto it = tasks.find(id);
    return it == tasks.end() ? nullptr : it->second;
  }

  void wait_all() {
    std::unique_lock<std::mutex> l(mu);
    cv_done.wait(l, [this] { return queue.empty() && active == 0; });
  }

  bool wait_task(int64_t id) {
    std::unique_lock<std::mutex> l(mu);
    auto it = tasks.find(id);
    if (it == tasks.end()) return false;
    TaskState* st = it->second;
    cv_done.wait(l, [st] { return st->done.load(); });
    return true;
  }
};

}  // namespace

extern "C" {

void* taskpool_create(int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  return new Pool(n_threads);
}

void taskpool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int64_t taskpool_submit(void* pool, task_fn fn, void* ctx) {
  return static_cast<Pool*>(pool)->submit(fn, ctx);
}

void taskpool_wait_all(void* pool) { static_cast<Pool*>(pool)->wait_all(); }

int taskpool_wait_task(void* pool, int64_t id) {
  return static_cast<Pool*>(pool)->wait_task(id) ? 1 : 0;
}

void task_cancel(void* pool, int64_t id) {
  auto* st = static_cast<Pool*>(pool)->state(id);
  if (st) st->cancelled.store(true);
}

int task_is_cancelled(void* pool, int64_t id) {
  auto* st = static_cast<Pool*>(pool)->state(id);
  return st && st->cancelled.load() ? 1 : 0;
}

void task_set_progress(void* pool, int64_t id, int step) {
  auto* st = static_cast<Pool*>(pool)->state(id);
  if (st) st->progress.store(step);
}

int task_get_progress(void* pool, int64_t id) {
  auto* st = static_cast<Pool*>(pool)->state(id);
  return st ? st->progress.load() : -1;
}

int task_is_done(void* pool, int64_t id) {
  auto* st = static_cast<Pool*>(pool)->state(id);
  return st && st->done.load() ? 1 : 0;
}

}  // extern "C"
